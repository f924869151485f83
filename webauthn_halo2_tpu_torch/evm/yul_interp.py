"""Dry-run interpreter for the generated verifier Yul.

The port's copy of the JAX package's evm/yul_interp.py.

The revm-dry-run parity step (SURVEY §4.4: the reference deploys its
generated Yul in revm and asserts a real proof passes —
ecdsa_p256.rs:303-324). There is no solc/EVM in this build environment, so
we interpret the generated straight-line Yul subset directly: lets,
mstore, if/revert, return, and calls to {addmod, mulmod, mod, add, sub,
mul, iszero, eq, lt, keccak256, calldataload, calldatasize, mload,
staticcall, gas}; precompiles 0x05-0x08 are backed by the host field /
curve / pairing oracles.
"""
from __future__ import annotations

import re

from ..fields.constants import BN254_FQ
from ..fields.pairing import pairing_check
from ..fields.ref_curve import BN254_G1_CURVE
from ..utils.keccak import keccak256

W = 1 << 256


class Reverted(Exception):
    pass


class Returned(Exception):
    pass


class YulVM:
    def __init__(self, calldata: bytes):
        self.calldata = calldata
        self.mem = bytearray()
        self.env: dict[str, int] = {}

    # --- memory ----------------------------------------------------------
    def _ensure(self, end: int) -> None:
        if len(self.mem) < end:
            self.mem.extend(bytes(end - len(self.mem)))

    def mstore(self, off: int, val: int) -> None:
        self._ensure(off + 32)
        self.mem[off : off + 32] = (val % W).to_bytes(32, "big")

    def mload(self, off: int) -> int:
        self._ensure(off + 32)
        return int.from_bytes(self.mem[off : off + 32], "big")

    # --- builtins --------------------------------------------------------
    def call(self, fn: str, args: list[int]) -> int:
        if fn == "addmod":
            return (args[0] + args[1]) % args[2]
        if fn == "mulmod":
            return (args[0] * args[1]) % args[2]
        if fn == "mod":
            return args[0] % args[1]
        if fn == "add":
            return (args[0] + args[1]) % W
        if fn == "sub":
            return (args[0] - args[1]) % W
        if fn == "mul":
            return (args[0] * args[1]) % W
        if fn == "iszero":
            return 1 if args[0] == 0 else 0
        if fn == "eq":
            return 1 if args[0] == args[1] else 0
        if fn == "lt":
            return 1 if args[0] < args[1] else 0
        if fn == "gas":
            return 10**9
        if fn == "calldatasize":
            return len(self.calldata)
        if fn == "calldataload":
            off = args[0]
            chunk = self.calldata[off : off + 32]
            return int.from_bytes(chunk.ljust(32, b"\0"), "big")
        if fn == "mload":
            return self.mload(args[0])
        if fn == "keccak256":
            off, ln = args
            self._ensure(off + ln)
            return int.from_bytes(
                keccak256(bytes(self.mem[off : off + ln])), "big"
            )
        if fn == "staticcall":
            return self.staticcall(*args)
        if fn == "mstore":
            self.mstore(args[0], args[1])
            return 0
        if fn == "revert":
            raise Reverted()
        if fn == "return":
            raise Returned()
        raise ValueError(f"unknown builtin {fn}")

    def staticcall(self, _gas, addr, in_off, in_sz, out_off, out_sz) -> int:
        data = bytes(self.mem[in_off : in_off + in_sz]) if in_sz else b""
        self._ensure(in_off + in_sz)
        data = bytes(self.mem[in_off : in_off + in_sz])
        if addr == 5:  # modexp
            bl = int.from_bytes(data[0:32], "big")
            el = int.from_bytes(data[32:64], "big")
            ml = int.from_bytes(data[64:96], "big")
            base = int.from_bytes(data[96 : 96 + bl], "big")
            exp = int.from_bytes(data[96 + bl : 96 + bl + el], "big")
            mod = int.from_bytes(data[96 + bl + el : 96 + bl + el + ml], "big")
            res = pow(base, exp, mod) if mod else 0
            self.mstore(out_off, res)
            return 1
        if addr == 6:  # ecAdd
            x1, y1 = (int.from_bytes(data[0:32], "big"),
                      int.from_bytes(data[32:64], "big"))
            x2, y2 = (int.from_bytes(data[64:96], "big"),
                      int.from_bytes(data[96:128], "big"))
            p1 = None if (x1, y1) == (0, 0) else (x1, y1)
            p2 = None if (x2, y2) == (0, 0) else (x2, y2)
            if (p1 and not BN254_G1_CURVE.is_on_curve(p1)) or (
                p2 and not BN254_G1_CURVE.is_on_curve(p2)
            ):
                return 0
            r = BN254_G1_CURVE.add(p1, p2)
            self.mstore(out_off, r[0] if r else 0)
            self.mstore(out_off + 32, r[1] if r else 0)
            return 1
        if addr == 7:  # ecMul
            x, y = (int.from_bytes(data[0:32], "big"),
                    int.from_bytes(data[32:64], "big"))
            s = int.from_bytes(data[64:96], "big")
            p = None if (x, y) == (0, 0) else (x, y)
            if p and not BN254_G1_CURVE.is_on_curve(p):
                return 0
            r = BN254_G1_CURVE.mul(s, p) if p else None
            self.mstore(out_off, r[0] if r else 0)
            self.mstore(out_off + 32, r[1] if r else 0)
            return 1
        if addr == 8:  # pairing
            assert in_sz % 192 == 0
            pairs = []
            for i in range(in_sz // 192):
                b = data[192 * i : 192 * (i + 1)]
                x = int.from_bytes(b[0:32], "big")
                y = int.from_bytes(b[32:64], "big")
                x1 = int.from_bytes(b[64:96], "big")
                x0 = int.from_bytes(b[96:128], "big")
                y1 = int.from_bytes(b[128:160], "big")
                y0 = int.from_bytes(b[160:192], "big")
                g1 = None if (x, y) == (0, 0) else (x, y)
                if g1 and not BN254_G1_CURVE.is_on_curve(g1):
                    return 0
                pairs.append((g1, ((x0, x1), (y0, y1))))
            ok = pairing_check(pairs)
            self.mstore(out_off, 1 if ok else 0)
            return 1
        raise ValueError(f"unsupported precompile {addr}")

    # --- expression parsing ----------------------------------------------
    _TOKEN = re.compile(r"\s*([A-Za-z_][A-Za-z_0-9]*|0x[0-9a-fA-F]+|\d+|[(),])")

    def eval_expr(self, s: str) -> int:
        toks = self._TOKEN.findall(s)
        val, rest = self._parse(toks)
        assert not rest, f"trailing tokens in {s!r}"
        return val

    def _parse(self, toks: list[str]):
        tok, *rest = toks
        if tok.startswith("0x"):
            return int(tok, 16), rest
        if tok.isdigit():
            return int(tok), rest
        if rest and rest[0] == "(":
            rest = rest[1:]
            args = []
            if rest[0] != ")":
                while True:
                    v, rest = self._parse(rest)
                    args.append(v)
                    if rest[0] == ",":
                        rest = rest[1:]
                        continue
                    break
            assert rest[0] == ")"
            return self.call(tok, args), rest[1:]
        return self.env[tok], rest

    # --- statement execution ----------------------------------------------
    def run_lines(self, lines: list[str]) -> bool:
        """True = accepted (return reached), False = reverted."""
        try:
            for ln in lines:
                ln = ln.strip()
                if not ln or ln.startswith("//"):
                    continue
                if ln.startswith("let "):
                    name, expr = ln[4:].split(":=", 1)
                    self.env[name.strip()] = self.eval_expr(expr.strip())
                elif ln.startswith("if "):
                    m = re.match(r"if (.*) \{ revert\(0, 0\) \}$", ln)
                    assert m, f"unsupported if form: {ln!r}"
                    if self.eval_expr(m.group(1)):
                        raise Reverted()
                elif ln.startswith("mstore("):
                    self.eval_expr(ln)
                elif ln == "return(0, 0)":
                    raise Returned()
                else:
                    raise ValueError(f"unsupported statement {ln!r}")
        except Reverted:
            return False
        except Returned:
            return True
        raise ValueError("verifier fell off the end without return/revert")


def run_yul_verifier(yul_source: str, proof: bytes) -> bool:
    """Extract the Runtime body from the generated Yul and execute it."""
    body = yul_source.split('object "Runtime"', 1)[1]
    body = body.split("code {", 1)[1]
    # strip the trailing braces of code/object/object
    lines = body.rsplit("}", 3)[0].strip().splitlines()
    vm = YulVM(proof)
    return vm.run_lines([ln.strip() for ln in lines])
