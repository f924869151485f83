"""Client-side ABI + ERC-4337 helpers (the ethers/userop.js role in the
reference web demo, index.tsx:296-414): UserOperation struct, v0.6 ABI
encoding, and userOpHash computation.

The port's copy of the JAX package's chain/abi.py, over the port's
utils/keccak.py."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.keccak import keccak256


def selector(sig: str) -> int:
    return int.from_bytes(keccak256(sig.encode())[:4], "big")


def _w(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _ceil32(n: int) -> int:
    return (n + 31) & ~31


def _pad(b: bytes) -> bytes:
    return b.ljust(_ceil32(len(b)), b"\0")


def encode_bytes(b: bytes) -> bytes:
    return _w(len(b)) + _pad(b)


@dataclass
class UserOperation:
    """UserOperation v0.6 (interfaces/UserOperation.sol parity)."""

    sender: int
    nonce: int = 0
    init_code: bytes = b""
    call_data: bytes = b""
    call_gas_limit: int = 10_000_000
    verification_gas_limit: int = 10_000_000
    pre_verification_gas: int = 1_000_000
    max_fee_per_gas: int = 10_000_000
    max_priority_fee_per_gas: int = 10_000_000
    paymaster_and_data: bytes = b""
    signature: bytes = field(default=b"", repr=False)

    # -- struct encoding ----------------------------------------------------
    def encode_struct(self) -> bytes:
        """ABI encoding of the struct alone (head offsets relative to the
        struct start; dynamic tails in field order — the EntryPoint's
        opLen() relies on signature being the last tail)."""
        dyn = [self.init_code, self.call_data, self.paymaster_and_data,
               self.signature]
        head_len = 11 * 32
        tails: list[bytes] = []
        offsets: list[int] = []
        pos = head_len
        for d in dyn:
            offsets.append(pos)
            t = encode_bytes(d)
            tails.append(t)
            pos += len(t)
        head = b"".join([
            _w(self.sender), _w(self.nonce), _w(offsets[0]), _w(offsets[1]),
            _w(self.call_gas_limit), _w(self.verification_gas_limit),
            _w(self.pre_verification_gas), _w(self.max_fee_per_gas),
            _w(self.max_priority_fee_per_gas), _w(offsets[2]),
            _w(offsets[3]),
        ])
        return head + b"".join(tails)

    # -- hashing (UserOperationLib.hash parity) -----------------------------
    def pack_for_hash(self) -> bytes:
        return b"".join([
            _w(self.sender), _w(self.nonce),
            keccak256(self.init_code), keccak256(self.call_data),
            _w(self.call_gas_limit), _w(self.verification_gas_limit),
            _w(self.pre_verification_gas), _w(self.max_fee_per_gas),
            _w(self.max_priority_fee_per_gas),
            keccak256(self.paymaster_and_data),
        ])

    def hash(self, entry_point: int, chain_id: int) -> bytes:
        inner = keccak256(self.pack_for_hash())
        return keccak256(inner + _w(entry_point) + _w(chain_id))


def encode_handle_ops(ops: list[UserOperation], beneficiary: int) -> bytes:
    """calldata for EntryPoint.handleOps(UserOperation[], address)."""
    sel = selector(
        "handleOps((address,uint256,bytes,bytes,uint256,uint256,uint256,"
        "uint256,uint256,bytes,bytes)[],address)"
    )
    structs = [op.encode_struct() for op in ops]
    # array data: length + per-op offsets (relative to array data start)
    arr_head = _w(len(ops))
    off = 32 * len(ops)
    offs = []
    for s in structs:
        offs.append(off)
        off += len(s)
    arr = arr_head + b"".join(_w(o) for o in offs) + b"".join(structs)
    # top-level: offset to array (0x40), beneficiary
    return sel.to_bytes(4, "big") + _w(0x40) + _w(beneficiary) + arr


def encode_ops_array(ops: list["UserOperation"]) -> bytes:
    """ABI bytes of a UserOperation[] (length + element offsets + tails)."""
    structs = [op.encode_struct() for op in ops]
    off = 32 * len(ops)
    offs = []
    for s in structs:
        offs.append(off)
        off += len(s)
    return _w(len(ops)) + b"".join(_w(o) for o in offs) + b"".join(structs)


def encode_handle_aggregated_ops(
        groups: list[tuple[list["UserOperation"], int, bytes]],
        beneficiary: int) -> bytes:
    """calldata for EntryPoint.handleAggregatedOps(
    (UserOperation[] userOps, address aggregator, bytes signature)[],
    address beneficiary) — core/EntryPoint.sol:228 /
    interfaces/IAggregator.sol parity."""
    sel = selector(
        "handleAggregatedOps(((address,uint256,bytes,bytes,uint256,uint256,"
        "uint256,uint256,uint256,bytes,bytes)[],address,bytes)[],address)"
    )
    g_structs = []
    for ops, aggregator, sig in groups:
        arr = encode_ops_array(ops)
        # struct head: ops offset, aggregator, signature offset; tails in
        # field order (ops array then signature — the EntryPoint's
        # calldata-rebuild for validateSignatures relies on this layout)
        head = _w(0x60) + _w(aggregator) + _w(0x60 + len(arr))
        g_structs.append(head + arr + encode_bytes(sig))
    off = 32 * len(groups)
    offs = []
    for s in g_structs:
        offs.append(off)
        off += len(s)
    arr = (_w(len(groups)) + b"".join(_w(o) for o in offs)
           + b"".join(g_structs))
    return sel.to_bytes(4, "big") + _w(0x40) + _w(beneficiary) + arr


def encode_simulate_validation(op: "UserOperation") -> bytes:
    """calldata for EntryPoint.simulateValidation(UserOperation)
    (core/EntryPoint.sol:503 — always reverts with ValidationResult or
    FailedOp)."""
    sel = selector(
        "simulateValidation((address,uint256,bytes,bytes,uint256,uint256,"
        "uint256,uint256,uint256,bytes,bytes))"
    )
    return sel.to_bytes(4, "big") + _w(0x20) + op.encode_struct()


def encode_execute(dest: int, value: int, func: bytes) -> bytes:
    """calldata for P256Account.execute(address,uint256,bytes)."""
    return (selector("execute(address,uint256,bytes)").to_bytes(4, "big")
            + _w(dest) + _w(value) + _w(0x60) + encode_bytes(func))


def encode_create_account(public_key: bytes) -> bytes:
    """calldata for P256AccountFactory.createAccount(bytes)."""
    return (selector("createAccount(bytes)").to_bytes(4, "big")
            + _w(0x20) + encode_bytes(public_key))


def encode_get_address(public_key: bytes) -> bytes:
    return (selector("getAddress(bytes)").to_bytes(4, "big")
            + _w(0x20) + encode_bytes(public_key))


def init_code_for(factory: int, public_key: bytes) -> bytes:
    """UserOperation.initCode = factory address ++ createAccount calldata
    (the web demo's initCode-if-undeployed assembly, index.tsx:327-341)."""
    return factory.to_bytes(20, "big") + encode_create_account(public_key)
