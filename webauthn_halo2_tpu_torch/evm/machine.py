"""A real EVM bytecode machine with gas metering.

The port's copy of the JAX package's evm/machine.py, over the port's
fields/ and utils/ (its pairing and Keccak are pure Python).

Replaces the reference's use of revm (snark-verifier `ExecutorBuilder`,
ecdsa_p256.rs:306-323: deploy the compiled verifier, dry-run a proof,
print gas) and foundry (contracts/test/*.t.sol). The generated verifier
is ASSEMBLED to real bytecode (evm/yul_asm.py) and executed here at the
opcode level, with gas accounting following the Yellow Paper + the live
forks relevant to the contracts (EIP-150/2929 warm-cold accounting,
EIP-2565 modexp, EIP-1108 bn254 precompile costs, EIP-3860 initcode).

Scope: a single-threaded in-process chain: accounts, storage, value
transfer, CREATE/CREATE2, nested message calls (CALL/STATICCALL/
DELEGATECALL), precompiles 0x01-0x09, logs, revert data. No gas refunds
beyond SSTORE clears, no EIP-1559 fee machinery (not needed for tests).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.constants import BN254_FQ
from ..fields.pairing import pairing_check
from ..fields.ref_curve import BN254_G1_CURVE
from ..utils.keccak import keccak256

W = 1 << 256
MAXU = W - 1


def _s(x: int) -> int:
    """unsigned -> signed"""
    return x - W if x >= (1 << 255) else x


def _u(x: int) -> int:
    return x % W


class EvmError(Exception):
    pass


class OutOfGas(EvmError):
    pass


@dataclass
class Account:
    balance: int = 0
    nonce: int = 0
    code: bytes = b""
    storage: dict = field(default_factory=dict)


@dataclass
class Log:
    address: int
    topics: list
    data: bytes


@dataclass
class CallResult:
    success: bool
    output: bytes
    gas_used: int
    logs: list


class Chain:
    """World state + transaction-level execution entry points."""

    def __init__(self):
        self.accounts: dict[int, Account] = {}
        self.block_number = 1
        self.timestamp = 1_700_000_000
        self.chain_id = 31337

    def account(self, addr: int) -> Account:
        if addr not in self.accounts:
            self.accounts[addr] = Account()
        return self.accounts[addr]

    def set_balance(self, addr: int, wei: int) -> None:
        self.account(addr).balance = wei

    # --- transaction entry points -----------------------------------------
    def create(self, sender: int, initcode: bytes, value: int = 0,
               gas: int = 500_000_000, salt: int | None = None) -> tuple[int, CallResult]:
        """Deploy a contract (CREATE semantics; CREATE2 when salt given)."""
        acct = self.account(sender)
        if salt is None:
            rlpish = sender.to_bytes(20, "big") + acct.nonce.to_bytes(8, "big")
            addr = int.from_bytes(keccak256(rlpish)[12:], "big")
        else:
            pre = (b"\xff" + sender.to_bytes(20, "big")
                   + salt.to_bytes(32, "big") + keccak256(initcode))
            addr = int.from_bytes(keccak256(pre)[12:], "big")
        acct.nonce += 1
        # value moves (and state snapshots) BEFORE the initcode frame runs:
        # initcode observing CALLVALUE/SELFBALANCE must see a funded account,
        # and a failed create must roll back nested-call mutations
        # (mirrors Chain.call)
        snapshot = self._snapshot()
        if value:
            if self.account(sender).balance < value:
                return addr, CallResult(False, b"", 0, [])
            self.account(sender).balance -= value
            self.account(addr).balance += value
        frame = Frame(self, caller=sender, address=addr, origin=sender,
                      code=initcode, data=b"", value=value, gas=gas,
                      static=False, accessed=_fresh_access(sender, addr))
        res = frame.run()
        if res.success:
            self.account(addr).code = res.output
            res = CallResult(True, b"", res.gas_used + 200 * len(res.output),
                             res.logs)
        else:
            self._restore(snapshot)
        return addr, res

    def deploy_runtime(self, runtime: bytes, addr: int | None = None) -> int:
        """Test helper: install runtime bytecode directly (vm.etch parity)."""
        if addr is None:
            addr = 0xC0DE0000 + len(self.accounts)
        self.account(addr).code = runtime
        return addr

    def call(self, sender: int, to: int, data: bytes = b"", value: int = 0,
             gas: int = 500_000_000, static: bool = False) -> CallResult:
        code = self.account(to).code
        snapshot = self._snapshot()
        if value:
            if self.account(sender).balance < value:
                return CallResult(False, b"", 0, [])
            self.account(sender).balance -= value
            self.account(to).balance += value
        frame = Frame(self, caller=sender, address=to, origin=sender,
                      code=code, data=data, value=value, gas=gas,
                      static=static, accessed=_fresh_access(sender, to))
        res = frame.run()
        if not res.success:
            self._restore(snapshot)
        return res

    # --- state snapshots for revert semantics -------------------------------
    def _snapshot(self):
        return {
            a: (acc.balance, acc.nonce, acc.code, dict(acc.storage))
            for a, acc in self.accounts.items()
        }

    def _restore(self, snap) -> None:
        self.accounts = {
            a: Account(b, n, c, dict(s)) for a, (b, n, c, s) in snap.items()
        }


def _fresh_access(sender: int, to: int):
    return ({sender, to} | set(range(1, 10)), set())


# ---------------------------------------------------------------------------
# gas schedule
# ---------------------------------------------------------------------------

G_VERYLOW, G_LOW, G_MID, G_HIGH = 3, 5, 8, 10
G_BASE, G_JUMPDEST = 2, 1
G_WARM, G_COLD_ACCOUNT, G_COLD_SLOAD = 100, 2600, 2100
G_SSTORE_SET, G_SSTORE_RESET = 20000, 2900
G_CREATE, G_CODE_DEPOSIT = 32000, 200
G_LOG, G_LOGDATA, G_LOGTOPIC = 375, 8, 375
G_KECCAK, G_KECCAK_WORD = 30, 6
G_COPY_WORD = 3
G_NEW_ACCOUNT, G_CALLVALUE, G_CALLSTIPEND = 25000, 9000, 2300


def mem_gas(words: int) -> int:
    return 3 * words + words * words // 512


# ---------------------------------------------------------------------------
# interpreter frame
# ---------------------------------------------------------------------------

class Frame:
    def __init__(self, chain: Chain, caller: int, address: int, origin: int,
                 code: bytes, data: bytes, value: int, gas: int, static: bool,
                 accessed, depth: int = 0):
        self.chain = chain
        self.caller = caller
        self.address = address
        self.origin = origin
        self.code = code
        self.data = data
        self.value = value
        self.gas = gas
        self.static = static
        self.depth = depth
        self.accessed_addrs, self.accessed_slots = accessed
        self.stack: list[int] = []
        self.mem = bytearray()
        self.pc = 0
        self.logs: list[Log] = []
        self.returndata = b""
        self._valid_jumpdests = _jumpdests(code)

    # --- helpers -----------------------------------------------------------
    def use(self, g: int) -> None:
        self.gas -= g
        if self.gas < 0:
            raise OutOfGas()

    def expand_mem(self, off: int, size: int) -> None:
        if size == 0:
            return
        end = off + size
        cur_words = (len(self.mem) + 31) // 32
        new_words = (end + 31) // 32
        if new_words > cur_words:
            self.use(mem_gas(new_words) - mem_gas(cur_words))
            self.mem.extend(bytes(new_words * 32 - len(self.mem)))

    def mread(self, off: int, size: int) -> bytes:
        self.expand_mem(off, size)
        return bytes(self.mem[off : off + size])

    def mwrite(self, off: int, data: bytes) -> None:
        self.expand_mem(off, len(data))
        self.mem[off : off + len(data)] = data

    def push(self, v: int) -> None:
        if len(self.stack) >= 1024:
            raise EvmError("stack overflow")
        self.stack.append(v & MAXU)

    def pop(self) -> int:
        if not self.stack:
            raise EvmError("stack underflow")
        return self.stack.pop()

    # --- main loop -----------------------------------------------------------
    def run(self) -> CallResult:
        gas0 = self.gas
        try:
            out = self._execute()
            return CallResult(True, out, gas0 - self.gas, self.logs)
        except _Revert as r:
            return CallResult(False, r.data, gas0 - self.gas, [])
        except (EvmError, OutOfGas):
            return CallResult(False, b"", gas0, [])

    def _execute(self) -> bytes:
        code = self.code
        n = len(code)
        while self.pc < n:
            op = code[self.pc]
            self.pc += 1
            handler = _DISPATCH.get(op)
            if handler is None:
                raise EvmError(f"invalid opcode 0x{op:02x}")
            out = handler(self)
            if out is not None:
                return out
        return b""


class _Revert(Exception):
    def __init__(self, data: bytes):
        self.data = data


def _jumpdests(code: bytes) -> set:
    out = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            out.add(i)
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return out


# ---------------------------------------------------------------------------
# opcode handlers
# ---------------------------------------------------------------------------

_DISPATCH: dict = {}


def _op(code: int, gas: int | None = None):
    def deco(fn):
        if gas is not None:
            def wrapped(f: Frame, _fn=fn, _g=gas):
                f.use(_g)
                return _fn(f)
            _DISPATCH[code] = wrapped
        else:
            _DISPATCH[code] = fn
        return fn
    return deco


@_op(0x00)  # STOP
def _stop(f):
    return b""


@_op(0x01, G_VERYLOW)
def _add(f):
    f.push(f.pop() + f.pop())


@_op(0x02, G_LOW)
def _mul(f):
    f.push(f.pop() * f.pop())


@_op(0x03, G_VERYLOW)
def _sub(f):
    a, b = f.pop(), f.pop()
    f.push(a - b)


@_op(0x04, G_LOW)
def _div(f):
    a, b = f.pop(), f.pop()
    f.push(a // b if b else 0)


@_op(0x05, G_LOW)
def _sdiv(f):
    a, b = _s(f.pop()), _s(f.pop())
    f.push(0 if b == 0 else abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1))


@_op(0x06, G_LOW)
def _mod(f):
    a, b = f.pop(), f.pop()
    f.push(a % b if b else 0)


@_op(0x07, G_LOW)
def _smod(f):
    a, b = _s(f.pop()), _s(f.pop())
    f.push(0 if b == 0 else (abs(a) % abs(b)) * (1 if a >= 0 else -1))


@_op(0x08, G_MID)
def _addmod(f):
    a, b, m = f.pop(), f.pop(), f.pop()
    f.push((a + b) % m if m else 0)


@_op(0x09, G_MID)
def _mulmod(f):
    a, b, m = f.pop(), f.pop(), f.pop()
    f.push((a * b) % m if m else 0)


@_op(0x0A)  # EXP
def _exp(f):
    a, e = f.pop(), f.pop()
    f.use(10 + 50 * ((e.bit_length() + 7) // 8))
    f.push(pow(a, e, W))


@_op(0x0B, G_LOW)  # SIGNEXTEND
def _signextend(f):
    b, x = f.pop(), f.pop()
    if b < 31:
        bit = 8 * (b + 1) - 1
        if x & (1 << bit):
            x |= MAXU ^ ((1 << (bit + 1)) - 1)
        else:
            x &= (1 << (bit + 1)) - 1
    f.push(x)


@_op(0x10, G_VERYLOW)
def _lt(f):
    a, b = f.pop(), f.pop()
    f.push(1 if a < b else 0)


@_op(0x11, G_VERYLOW)
def _gt(f):
    a, b = f.pop(), f.pop()
    f.push(1 if a > b else 0)


@_op(0x12, G_VERYLOW)
def _slt(f):
    a, b = _s(f.pop()), _s(f.pop())
    f.push(1 if a < b else 0)


@_op(0x13, G_VERYLOW)
def _sgt(f):
    a, b = _s(f.pop()), _s(f.pop())
    f.push(1 if a > b else 0)


@_op(0x14, G_VERYLOW)
def _eq(f):
    f.push(1 if f.pop() == f.pop() else 0)


@_op(0x15, G_VERYLOW)
def _iszero(f):
    f.push(1 if f.pop() == 0 else 0)


@_op(0x16, G_VERYLOW)
def _and(f):
    f.push(f.pop() & f.pop())


@_op(0x17, G_VERYLOW)
def _or(f):
    f.push(f.pop() | f.pop())


@_op(0x18, G_VERYLOW)
def _xor(f):
    f.push(f.pop() ^ f.pop())


@_op(0x19, G_VERYLOW)
def _not(f):
    f.push(f.pop() ^ MAXU)


@_op(0x1A, G_VERYLOW)
def _byte(f):
    i, x = f.pop(), f.pop()
    f.push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)


@_op(0x1B, G_VERYLOW)
def _shl(f):
    s, v = f.pop(), f.pop()
    f.push(v << s if s < 256 else 0)


@_op(0x1C, G_VERYLOW)
def _shr(f):
    s, v = f.pop(), f.pop()
    f.push(v >> s if s < 256 else 0)


@_op(0x1D, G_VERYLOW)
def _sar(f):
    s, v = f.pop(), _s(f.pop())
    f.push(v >> s if s < 256 else (0 if v >= 0 else MAXU))


@_op(0x20)  # KECCAK256
def _sha3(f):
    off, size = f.pop(), f.pop()
    f.use(G_KECCAK + G_KECCAK_WORD * ((size + 31) // 32))
    f.push(int.from_bytes(keccak256(f.mread(off, size)), "big"))


@_op(0x30, G_BASE)
def _address(f):
    f.push(f.address)


@_op(0x31)  # BALANCE
def _balance(f):
    a = f.pop()
    f.use(G_WARM if a in f.accessed_addrs else G_COLD_ACCOUNT)
    f.accessed_addrs.add(a)
    f.push(f.chain.account(a).balance)


@_op(0x32, G_BASE)
def _origin(f):
    f.push(f.origin)


@_op(0x33, G_BASE)
def _caller(f):
    f.push(f.caller)


@_op(0x34, G_BASE)
def _callvalue(f):
    f.push(f.value)


@_op(0x35, G_VERYLOW)
def _calldataload(f):
    off = f.pop()
    chunk = f.data[off : off + 32]
    f.push(int.from_bytes(chunk.ljust(32, b"\0"), "big"))


@_op(0x36, G_BASE)
def _calldatasize(f):
    f.push(len(f.data))


@_op(0x37)  # CALLDATACOPY
def _calldatacopy(f):
    dst, src, size = f.pop(), f.pop(), f.pop()
    f.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
    f.mwrite(dst, f.data[src : src + size].ljust(size, b"\0"))


@_op(0x38, G_BASE)
def _codesize(f):
    f.push(len(f.code))


@_op(0x39)  # CODECOPY
def _codecopy(f):
    dst, src, size = f.pop(), f.pop(), f.pop()
    f.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
    f.mwrite(dst, f.code[src : src + size].ljust(size, b"\0"))


@_op(0x3A, G_BASE)
def _gasprice(f):
    f.push(0)


@_op(0x3B)  # EXTCODESIZE
def _extcodesize(f):
    a = f.pop()
    f.use(G_WARM if a in f.accessed_addrs else G_COLD_ACCOUNT)
    f.accessed_addrs.add(a)
    f.push(len(f.chain.account(a).code))


@_op(0x3C)  # EXTCODECOPY
def _extcodecopy(f):
    a, dst, src, size = f.pop(), f.pop(), f.pop(), f.pop()
    f.use((G_WARM if a in f.accessed_addrs else G_COLD_ACCOUNT)
          + G_COPY_WORD * ((size + 31) // 32))
    f.accessed_addrs.add(a)
    code = f.chain.account(a).code
    f.mwrite(dst, code[src : src + size].ljust(size, b"\0"))


@_op(0x3D, G_BASE)
def _returndatasize(f):
    f.push(len(f.returndata))


@_op(0x3E)  # RETURNDATACOPY
def _returndatacopy(f):
    dst, src, size = f.pop(), f.pop(), f.pop()
    f.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
    if src + size > len(f.returndata):
        raise EvmError("returndatacopy out of bounds")
    f.mwrite(dst, f.returndata[src : src + size])


@_op(0x3F)  # EXTCODEHASH
def _extcodehash(f):
    a = f.pop()
    f.use(G_WARM if a in f.accessed_addrs else G_COLD_ACCOUNT)
    f.accessed_addrs.add(a)
    code = f.chain.account(a).code
    f.push(int.from_bytes(keccak256(code), "big") if code else 0)


@_op(0x40, G_BASE)  # BLOCKHASH (stub)
def _blockhash(f):
    f.pop()
    f.push(0)


@_op(0x41, G_BASE)
def _coinbase(f):
    f.push(0)


@_op(0x42, G_BASE)
def _timestamp(f):
    f.push(f.chain.timestamp)


@_op(0x43, G_BASE)
def _number(f):
    f.push(f.chain.block_number)


@_op(0x44, G_BASE)
def _prevrandao(f):
    f.push(0)


@_op(0x45, G_BASE)
def _gaslimit(f):
    f.push(30_000_000)


@_op(0x46, G_BASE)
def _chainid(f):
    f.push(f.chain.chain_id)


@_op(0x47, G_BASE)
def _selfbalance(f):
    f.push(f.chain.account(f.address).balance)


@_op(0x48, G_BASE)
def _basefee(f):
    f.push(0)


@_op(0x50, G_BASE)
def _pop(f):
    f.pop()


@_op(0x51)  # MLOAD
def _mload(f):
    off = f.pop()
    f.use(G_VERYLOW)
    f.push(int.from_bytes(f.mread(off, 32), "big"))


@_op(0x52)  # MSTORE
def _mstore(f):
    off, val = f.pop(), f.pop()
    f.use(G_VERYLOW)
    f.mwrite(off, val.to_bytes(32, "big"))


@_op(0x53)  # MSTORE8
def _mstore8(f):
    off, val = f.pop(), f.pop()
    f.use(G_VERYLOW)
    f.mwrite(off, bytes([val & 0xFF]))


@_op(0x54)  # SLOAD
def _sload(f):
    key = f.pop()
    skey = (f.address, key)
    f.use(G_WARM if skey in f.accessed_slots else G_COLD_SLOAD)
    f.accessed_slots.add(skey)
    f.push(f.chain.account(f.address).storage.get(key, 0))


@_op(0x55)  # SSTORE
def _sstore(f):
    if f.static:
        raise EvmError("SSTORE in static context")
    key, val = f.pop(), f.pop()
    skey = (f.address, key)
    cold = 0 if skey in f.accessed_slots else G_COLD_SLOAD
    f.accessed_slots.add(skey)
    store = f.chain.account(f.address).storage
    cur = store.get(key, 0)
    if cur == val:
        f.use(G_WARM + cold)
    elif cur == 0:
        f.use(G_SSTORE_SET + cold)
    else:
        f.use(G_SSTORE_RESET + cold)
    if val:
        store[key] = val
    else:
        store.pop(key, None)


@_op(0x56)  # JUMP
def _jump(f):
    dst = f.pop()
    f.use(G_MID)
    if dst not in f._valid_jumpdests:
        raise EvmError("bad jump destination")
    f.pc = dst


@_op(0x57)  # JUMPI
def _jumpi(f):
    dst, cond = f.pop(), f.pop()
    f.use(G_HIGH)
    if cond:
        if dst not in f._valid_jumpdests:
            raise EvmError("bad jump destination")
        f.pc = dst


@_op(0x58, G_BASE)
def _pc(f):
    f.push(f.pc - 1)


@_op(0x59, G_BASE)
def _msize(f):
    f.push(len(f.mem))


@_op(0x5A, G_BASE)
def _gas(f):
    f.push(max(f.gas, 0))


@_op(0x5B, G_JUMPDEST)
def _jumpdest(f):
    pass


@_op(0x5E)  # MCOPY (EIP-5656)
def _mcopy(f):
    dst, src, size = f.pop(), f.pop(), f.pop()
    f.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
    data = f.mread(src, size)
    f.mwrite(dst, data)


@_op(0x5F, G_BASE)  # PUSH0
def _push0(f):
    f.push(0)


def _make_push(nbytes: int):
    def push_n(f: Frame):
        f.use(G_VERYLOW)
        v = int.from_bytes(f.code[f.pc : f.pc + nbytes], "big")
        f.pc += nbytes
        f.push(v)
    return push_n


for _i in range(1, 33):
    _DISPATCH[0x5F + _i] = _make_push(_i)


def _make_dup(n: int):
    def dup_n(f: Frame):
        f.use(G_VERYLOW)
        if len(f.stack) < n:
            raise EvmError("stack underflow")
        f.push(f.stack[-n])
    return dup_n


for _i in range(1, 17):
    _DISPATCH[0x7F + _i] = _make_dup(_i)


def _make_swap(n: int):
    def swap_n(f: Frame):
        f.use(G_VERYLOW)
        if len(f.stack) < n + 1:
            raise EvmError("stack underflow")
        f.stack[-1], f.stack[-n - 1] = f.stack[-n - 1], f.stack[-1]
    return swap_n


for _i in range(1, 17):
    _DISPATCH[0x8F + _i] = _make_swap(_i)


def _make_log(ntopics: int):
    def log_n(f: Frame):
        if f.static:
            raise EvmError("LOG in static context")
        off, size = f.pop(), f.pop()
        topics = [f.pop() for _ in range(ntopics)]
        f.use(G_LOG + G_LOGTOPIC * ntopics + G_LOGDATA * size)
        f.logs.append(Log(f.address, topics, f.mread(off, size)))
    return log_n


for _i in range(5):
    _DISPATCH[0xA0 + _i] = _make_log(_i)


# --- calls / creates --------------------------------------------------------

def _do_create(f: Frame, salt: int | None):
    if f.static:
        raise EvmError("CREATE in static context")
    value, off, size = f.pop(), f.pop(), f.pop()
    if salt is not None:
        salt_v = f.pop()
    initcode = f.mread(off, size)
    f.use(G_CREATE + 2 * ((size + 31) // 32))  # EIP-3860 initcode word cost
    if salt is not None:
        f.use(G_KECCAK_WORD * ((size + 31) // 32))
    me = f.chain.account(f.address)
    if salt is None:
        pre = f.address.to_bytes(20, "big") + me.nonce.to_bytes(8, "big")
    else:
        pre = (b"\xff" + f.address.to_bytes(20, "big")
               + salt_v.to_bytes(32, "big") + keccak256(initcode))
    addr = int.from_bytes(keccak256(pre)[12:], "big")
    me.nonce += 1
    if f.chain.account(addr).code or f.depth + 1 > 1024:
        f.push(0)  # collision or call-depth limit: CREATE pushes 0
        return
    gas_fwd = f.gas - f.gas // 64
    snapshot = f.chain._snapshot()
    if value:
        if me.balance < value:
            f.push(0)
            return
        me.balance -= value
        f.chain.account(addr).balance += value
    sub = Frame(f.chain, caller=f.address, address=addr, origin=f.origin,
                code=initcode, data=b"", value=value, gas=gas_fwd,
                static=False, accessed=(f.accessed_addrs, f.accessed_slots),
                depth=f.depth + 1)
    res = sub.run()
    f.gas -= res.gas_used
    if res.success:
        f.use(G_CODE_DEPOSIT * len(res.output))
        f.chain.account(addr).code = res.output
        f.logs.extend(res.logs)
        f.returndata = b""
        f.push(addr)
    else:
        f.chain._restore(snapshot)
        f.returndata = res.output
        f.push(0)


@_op(0xF0)
def _create(f):
    _do_create(f, None)


@_op(0xF5)
def _create2(f):
    _do_create(f, 1)


def _do_call(f: Frame, op: int):
    gas_req = f.pop()
    to = f.pop()
    if op in (0xF1, 0xF2):  # CALL / CALLCODE
        value = f.pop()
    else:
        value = 0
    in_off, in_size, out_off, out_size = f.pop(), f.pop(), f.pop(), f.pop()
    if f.static and value and op == 0xF1:
        raise EvmError("value call in static context")
    f.use(G_WARM if to in f.accessed_addrs else G_COLD_ACCOUNT)
    f.accessed_addrs.add(to)
    data = f.mread(in_off, in_size)
    f.expand_mem(out_off, out_size)
    stipend = 0
    if value:
        f.use(G_CALLVALUE)
        stipend = G_CALLSTIPEND
        if op == 0xF1 and not f.chain.account(to).code \
                and f.chain.account(to).balance == 0 and to > 9:
            f.use(G_NEW_ACCOUNT)
    gas_avail = f.gas - f.gas // 64
    gas_fwd = min(gas_req, gas_avail) + stipend

    # precompiles
    if 1 <= to <= 9:
        ok, out, cost = _precompile(to, data)
        f.gas -= min(cost, gas_fwd)
        if cost > gas_fwd:
            ok, out = 0, b""
        f.returndata = out
        f.mwrite(out_off, out[:out_size].ljust(
            min(out_size, len(out)), b"\0"))
        f.push(ok)
        return

    if f.depth + 1 > 1024:  # EVM call-depth limit: the call fails cleanly
        f.push(0)
        f.returndata = b""
        return
    code = f.chain.account(to).code
    snapshot = f.chain._snapshot()
    if value and op == 0xF1:
        me = f.chain.account(f.address)
        if me.balance < value:
            f.push(0)
            f.returndata = b""
            return
        me.balance -= value
        f.chain.account(to).balance += value

    if op == 0xF1:  # CALL
        sub_addr, sub_caller, sub_value = to, f.address, value
        static = f.static
    elif op == 0xF2:  # CALLCODE
        sub_addr, sub_caller, sub_value = f.address, f.address, value
        static = f.static
    elif op == 0xF4:  # DELEGATECALL
        sub_addr, sub_caller, sub_value = f.address, f.caller, f.value
        static = f.static
    else:  # 0xFA STATICCALL
        sub_addr, sub_caller, sub_value = to, f.address, 0
        static = True

    sub = Frame(f.chain, caller=sub_caller, address=sub_addr, origin=f.origin,
                code=code, data=data, value=sub_value, gas=gas_fwd,
                static=static, accessed=(f.accessed_addrs, f.accessed_slots),
                depth=f.depth + 1)
    res = sub.run()
    f.gas -= max(res.gas_used - stipend, 0)
    f.returndata = res.output
    if res.success:
        f.logs.extend(res.logs)
    else:
        f.chain._restore(snapshot)
    f.mwrite(out_off, res.output[:out_size])
    f.push(1 if res.success else 0)


@_op(0xF1)
def _call(f):
    _do_call(f, 0xF1)


@_op(0xF2)
def _callcode(f):
    _do_call(f, 0xF2)


@_op(0xF4)
def _delegatecall(f):
    _do_call(f, 0xF4)


@_op(0xFA)
def _staticcall(f):
    _do_call(f, 0xFA)


@_op(0xF3)  # RETURN
def _return(f):
    off, size = f.pop(), f.pop()
    return f.mread(off, size)


@_op(0xFD)  # REVERT
def _revert(f):
    off, size = f.pop(), f.pop()
    raise _Revert(f.mread(off, size))


@_op(0xFE)
def _invalid(f):
    raise EvmError("INVALID opcode")


# ---------------------------------------------------------------------------
# precompiles (EIP-1108 / EIP-2565 gas)
# ---------------------------------------------------------------------------

def _precompile(addr: int, data: bytes) -> tuple[int, bytes, int]:
    if addr == 2:  # SHA-256
        import hashlib

        cost = 60 + 12 * ((len(data) + 31) // 32)
        return 1, hashlib.sha256(data).digest(), cost
    if addr == 4:  # identity
        return 1, data, 15 + 3 * ((len(data) + 31) // 32)
    if addr == 5:  # modexp
        d = data.ljust(96, b"\0")
        bl = int.from_bytes(d[0:32], "big")
        el = int.from_bytes(d[32:64], "big")
        ml = int.from_bytes(d[64:96], "big")
        rest = data[96:].ljust(bl + el + ml, b"\0")
        base = int.from_bytes(rest[0:bl], "big")
        exp = int.from_bytes(rest[bl : bl + el], "big")
        mod = int.from_bytes(rest[bl + el : bl + el + ml], "big")
        words = (max(bl, ml) + 7) // 8
        mult_c = words * words
        it = max(exp.bit_length() - 1, 0) if el <= 32 else 8 * (el - 32) + 255
        cost = max(200, mult_c * max(it, 1) // 3)
        out = (pow(base, exp, mod) if mod else 0).to_bytes(ml, "big") if ml else b""
        return 1, out, cost
    if addr == 6:  # bn254 add
        d = data.ljust(128, b"\0")
        x1, y1 = int.from_bytes(d[0:32], "big"), int.from_bytes(d[32:64], "big")
        x2, y2 = int.from_bytes(d[64:96], "big"), int.from_bytes(d[96:128], "big")
        if max(x1, y1, x2, y2) >= BN254_FQ:
            return 0, b"", 150
        p1 = None if (x1, y1) == (0, 0) else (x1, y1)
        p2 = None if (x2, y2) == (0, 0) else (x2, y2)
        if (p1 and not BN254_G1_CURVE.is_on_curve(p1)) or \
                (p2 and not BN254_G1_CURVE.is_on_curve(p2)):
            return 0, b"", 150
        r = BN254_G1_CURVE.add(p1, p2)
        rx, ry = r if r else (0, 0)
        return 1, rx.to_bytes(32, "big") + ry.to_bytes(32, "big"), 150
    if addr == 7:  # bn254 mul
        d = data.ljust(96, b"\0")
        x, y = int.from_bytes(d[0:32], "big"), int.from_bytes(d[32:64], "big")
        s = int.from_bytes(d[64:96], "big")
        if max(x, y) >= BN254_FQ:
            return 0, b"", 6000
        p = None if (x, y) == (0, 0) else (x, y)
        if p and not BN254_G1_CURVE.is_on_curve(p):
            return 0, b"", 6000
        r = BN254_G1_CURVE.mul(s, p) if p else None
        rx, ry = r if r else (0, 0)
        return 1, rx.to_bytes(32, "big") + ry.to_bytes(32, "big"), 6000
    if addr == 8:  # bn254 pairing
        if len(data) % 192:
            return 0, b"", 45000
        k = len(data) // 192
        cost = 45000 + 34000 * k
        pairs = []
        for i in range(k):
            b = data[192 * i : 192 * (i + 1)]
            x = int.from_bytes(b[0:32], "big")
            y = int.from_bytes(b[32:64], "big")
            x1 = int.from_bytes(b[64:96], "big")
            x0 = int.from_bytes(b[96:128], "big")
            y1 = int.from_bytes(b[128:160], "big")
            y0 = int.from_bytes(b[160:192], "big")
            g1 = None if (x, y) == (0, 0) else (x, y)
            if g1 and not BN254_G1_CURVE.is_on_curve(g1):
                return 0, b"", cost
            pairs.append((g1, ((x0, x1), (y0, y1))))
        ok = pairing_check(pairs)
        return 1, (1 if ok else 0).to_bytes(32, "big"), cost
    if addr in (1, 3, 9):
        raise EvmError(f"precompile 0x{addr:02x} not implemented")
    return 0, b"", 0
