"""Yul -> EVM bytecode assembler for the generated verifier.

The port's copy of the JAX package's evm/yul_asm.py.

The reference gets this from `snark_verifier::evm::compile_yul`
(ecdsa_p256.rs:326) which shells out to solc; no solc exists in this
image, so we assemble the codegen's straight-line Yul subset ourselves:

    let NAME := EXPR
    mstore(A, B)
    if EXPR { revert(0, 0) }
    return(0, 0)

with EXPR over {addmod mulmod mod add sub mul iszero eq lt keccak256
calldataload calldatasize mload staticcall gas}, literals, and local
variables. Locals are assigned MEMORY slots with linear-scan reuse (the
trace defines thousands of single-assignment temporaries — far beyond
EVM stack depth — but only a handful are ever live at once, so the slot
pool stays small and memory-expansion gas negligible). Literal-bound
locals (R_MOD/Q_MOD) are inlined as PUSH constants.

Output is a real deployable artifact: (deploy_bytecode, runtime_bytecode),
executed and gas-metered by evm/machine.py — the revm dry-run parity step
(ecdsa_p256.rs:303-324).
"""
from __future__ import annotations

import re

# opcode constants
OPS = dict(
    ADD=0x01, MUL=0x02, SUB=0x03, MOD=0x06, ADDMOD=0x08, MULMOD=0x09,
    LT=0x10, EQ=0x14, ISZERO=0x15, SHA3=0x20,
    CALLDATALOAD=0x35, CALLDATASIZE=0x36, CODECOPY=0x39,
    MLOAD=0x51, MSTORE=0x52, JUMP=0x56, JUMPI=0x57, GAS=0x5A, JUMPDEST=0x5B,
    STATICCALL=0xFA, RETURN=0xF3, REVERT=0xFD,
)

_CALL_OPS = {
    "add": OPS["ADD"], "mul": OPS["MUL"], "sub": OPS["SUB"],
    "mod": OPS["MOD"], "addmod": OPS["ADDMOD"], "mulmod": OPS["MULMOD"],
    "lt": OPS["LT"], "eq": OPS["EQ"], "iszero": OPS["ISZERO"],
    "keccak256": OPS["SHA3"], "calldataload": OPS["CALLDATALOAD"],
    "mload": OPS["MLOAD"], "staticcall": OPS["STATICCALL"],
}
_NULLARY = {"gas": 0x5A, "calldatasize": OPS["CALLDATASIZE"]}

_TOKEN = re.compile(r"\s*([A-Za-z_][A-Za-z_0-9]*|0x[0-9a-fA-F]+|\d+|[(),])")


def _parse_expr(s: str):
    toks = _TOKEN.findall(s)
    node, rest = _parse(toks)
    assert not rest, f"trailing tokens in {s!r}"
    return node


def _parse(toks):
    tok, *rest = toks
    if tok.startswith("0x"):
        return ("lit", int(tok, 16)), rest
    if tok.isdigit():
        return ("lit", int(tok)), rest
    if rest and rest[0] == "(":
        rest = rest[1:]
        args = []
        if rest[0] != ")":
            while True:
                node, rest = _parse(rest)
                args.append(node)
                if rest[0] == ",":
                    rest = rest[1:]
                    continue
                break
        assert rest[0] == ")"
        return ("call", tok, args), rest[1:]
    return ("var", tok), rest


def _vars_in(node, out: set):
    kind = node[0]
    if kind == "var":
        out.add(node[1])
    elif kind == "call":
        for a in node[2]:
            _vars_in(a, out)


def _push(v: int) -> bytes:
    if v == 0:
        return bytes([0x60, 0])  # PUSH1 0 (pre-Shanghai compatible)
    nb = (v.bit_length() + 7) // 8
    return bytes([0x5F + nb]) + v.to_bytes(nb, "big")


class YulAssembler:
    def __init__(self, lines: list[str], locals_base: int = 0x5000):
        self.lines = [ln.strip() for ln in lines
                      if ln.strip() and not ln.strip().startswith("//")]
        self.base = locals_base
        self.slot_of: dict[str, int] = {}
        self.inline: dict[str, int] = {}  # literal-bound locals
        self.free: list[int] = []
        self.high = 0
        self.last_use: dict[str, int] = {}
        self.code = bytearray()
        self.fixups: list[tuple[int, str]] = []  # (code offset, label)
        self.labels: dict[str, int] = {}
        self.n_labels = 0

    # --- slot management ----------------------------------------------------
    def _alloc(self, name: str) -> int:
        slot = self.free.pop() if self.free else self.base + 32 * self.high
        if slot == self.base + 32 * self.high:
            self.high += 1
        self.slot_of[name] = slot
        return slot

    def _release_dead(self, line_idx: int, stmt_vars: set) -> None:
        for v in stmt_vars:
            if self.last_use.get(v) == line_idx and v in self.slot_of:
                self.free.append(self.slot_of.pop(v))

    # --- code emission --------------------------------------------------------
    def _emit(self, *bs: int) -> None:
        self.code.extend(bs)

    def _emit_push_label(self, label: str) -> None:
        self.fixups.append((len(self.code) + 1, label))
        self._emit(0x62, 0, 0, 0)  # PUSH3 placeholder (runtime can be >64KB)

    def _label(self, label: str) -> None:
        self.labels[label] = len(self.code)
        self._emit(OPS["JUMPDEST"])

    def _compile_expr(self, node) -> None:
        kind = node[0]
        if kind == "lit":
            self.code.extend(_push(node[1]))
        elif kind == "var":
            name = node[1]
            if name in self.inline:
                self.code.extend(_push(self.inline[name]))
            else:
                self.code.extend(_push(self.slot_of[name]))
                self._emit(OPS["MLOAD"])
        else:
            _, fn, args = node
            if fn in _NULLARY:
                assert not args
                self._emit(_NULLARY[fn])
                return
            op = _CALL_OPS.get(fn)
            assert op is not None, f"unsupported builtin {fn}"
            for a in reversed(args):
                self._compile_expr(a)
            self._emit(op)

    # --- statements -----------------------------------------------------------
    def assemble_runtime(self) -> bytes:
        # pass 1: liveness
        for i, ln in enumerate(self.lines):
            used: set = set()
            if ln.startswith("let "):
                _, expr = ln[4:].split(":=", 1)
                _vars_in(_parse_expr(expr.strip()), used)
            elif ln.startswith("if "):
                m = re.match(r"if (.*) \{ revert\(0, 0\) \}$", ln)
                assert m, f"unsupported if form: {ln!r}"
                _vars_in(_parse_expr(m.group(1)), used)
            elif ln.startswith("mstore("):
                _vars_in(_parse_expr(ln), used)
            elif ln == "return(0, 0)":
                pass
            else:
                raise ValueError(f"unsupported statement {ln!r}")
            for v in used:
                self.last_use[v] = i

        # pass 2: emit
        for i, ln in enumerate(self.lines):
            used: set = set()
            if ln.startswith("let "):
                name, expr = ln[4:].split(":=", 1)
                name = name.strip()
                node = _parse_expr(expr.strip())
                _vars_in(node, used)
                if node[0] == "lit":
                    self.inline[name] = node[1]
                elif name not in self.last_use:
                    # dead assignment: evaluate for effects, drop result
                    self._compile_expr(node)
                    self._emit(0x50)  # POP
                else:
                    self._compile_expr(node)
                    slot = self._alloc(name)
                    self.code.extend(_push(slot))
                    self._emit(OPS["MSTORE"])
            elif ln.startswith("if "):
                m = re.match(r"if (.*) \{ revert\(0, 0\) \}$", ln)
                node = _parse_expr(m.group(1))
                _vars_in(node, used)
                self._compile_expr(node)
                self._emit(OPS["ISZERO"])
                lbl = f"L{self.n_labels}"
                self.n_labels += 1
                self._emit_push_label(lbl)
                self._emit(OPS["JUMPI"])
                self.code.extend(_push(0))
                self.code.extend(_push(0))
                self._emit(OPS["REVERT"])
                self._label(lbl)
            elif ln.startswith("mstore("):
                node = _parse_expr(ln)
                _vars_in(node, used)
                assert node[0] == "call" and node[1] == "mstore"
                off, val = node[2]
                self._compile_expr(val)
                self._compile_expr(off)
                self._emit(OPS["MSTORE"])
            elif ln == "return(0, 0)":
                self.code.extend(_push(0))
                self.code.extend(_push(0))
                self._emit(OPS["RETURN"])
            self._release_dead(i, used)

        # pass 3: fix label addresses
        for off, lbl in self.fixups:
            addr = self.labels[lbl]
            assert addr < (1 << 24)
            self.code[off : off + 3] = addr.to_bytes(3, "big")
        return bytes(self.code)

    @property
    def max_live_slots(self) -> int:
        return self.high


def wrap_deploy(runtime: bytes) -> bytes:
    """Constructor: CODECOPY the runtime to memory and RETURN it
    (the generated Yul object's `code` section parity). The runtime can
    exceed the EIP-170 mainnet size cap (like other generated PLONK
    verifiers, it would need a size pass or chain with a raised cap for
    production deploys); the local machine imposes no cap."""
    n = len(runtime)
    assert n < (1 << 24)
    body = bytearray()
    # CODECOPY(destOffset=0, offset=<len(init)>, length=n)
    # init length is fixed: PUSH3 n, PUSH3 off, PUSH1 0, CODECOPY,
    #                       PUSH3 n, PUSH1 0, RETURN  -> 18 bytes
    init_len = 18
    body += bytes([0x62]) + n.to_bytes(3, "big")           # PUSH3 n
    body += bytes([0x62]) + init_len.to_bytes(3, "big")    # PUSH3 off
    body += bytes([0x60, 0x00, 0x39])                      # PUSH1 0 CODECOPY
    body += bytes([0x62]) + n.to_bytes(3, "big")           # PUSH3 n
    body += bytes([0x60, 0x00, 0xF3])                      # PUSH1 0 RETURN
    assert len(body) == init_len
    return bytes(body) + runtime


def yul_body_lines(yul_source: str) -> list[str]:
    """Extract the Runtime body lines from the generated Yul object."""
    body = yul_source.split('object "Runtime"', 1)[1]
    body = body.split("code {", 1)[1]
    lines = body.rsplit("}", 3)[0].strip().splitlines()
    return [ln.strip() for ln in lines]


def compile_yul(yul_source: str, locals_base: int = 0x5000
                ) -> tuple[bytes, bytes]:
    """Generated-verifier Yul -> (deploy_bytecode, runtime_bytecode)."""
    asm = YulAssembler(yul_body_lines(yul_source), locals_base)
    runtime = asm.assemble_runtime()
    return wrap_deploy(runtime), runtime
