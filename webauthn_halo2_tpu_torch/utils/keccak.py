"""Keccak-256 (Ethereum variant).

Used by the EVM transcript (EvmTranscript parity — ecdsa_p256.rs:329-377),
verifier-side challenge derivation and the in-repo EVM. `keccak256` runs
in the native library (csrc/host/hashing.cpp, built at first use by
utils/host_build.py; a failed build raises); `keccak256_py`, from the
specification, is the tests' oracle for it.
"""
from __future__ import annotations

import ctypes

from . import host_build

# --- Keccak-f[1600] ---

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
        27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44]
_PI = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
       15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1]
_M = (1 << 64) - 1


def _rotl(x, n):
    return ((x << n) | (x >> (64 - n))) & _M


def _f1600(st):
    for rc in _RC:
        bc = [st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20]
              for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ _rotl(bc[(i + 1) % 5], 1)
            for j in range(0, 25, 5):
                st[j + i] ^= t
        t = st[1]
        for i in range(24):
            st[_PI[i]], t = _rotl(t, _ROT[i]), st[_PI[i]]
        for j in range(0, 25, 5):
            row = st[j : j + 5]
            for i in range(5):
                st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5] & _M)
        st[0] ^= rc


def keccak256_py(data: bytes) -> bytes:
    rate = 136
    st = [0] * 25
    padded = bytearray(bytes(data))
    padded.append(0x01)
    while len(padded) % rate:
        padded.append(0)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate // 8):
            st[i] ^= int.from_bytes(padded[off + 8 * i : off + 8 * i + 8], "little")
        _f1600(st)
    out = b"".join(st[i].to_bytes(8, "little") for i in range(4))
    return out


def keccak256(data: bytes) -> bytes:
    data = bytes(data)
    out = ctypes.create_string_buffer(32)
    host_build.load("hashing").wh2_keccak256(data, len(data), out)
    return out.raw
