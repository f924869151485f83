"""Fiat-Shamir transcripts (Blake2b now, Keccak/EVM variant alongside).

Mirrors the PSE halo2 transcript protocol consumed by the reference
(Blake2bWrite/Blake2bRead with Challenge255 — ecdsa_p256.rs:33-40):
  * 64-byte Blake2b state with personalization "Halo2-Transcript"
  * domain-prefix bytes: 0 = challenge squeeze, 1 = point, 2 = scalar
  * squeeze = finalize a clone of the running state, reduce 64 LE bytes
    into Fr (from_bytes_wide)
  * G1 points absorbed as (x, y) 32-byte LE reprs; serialized into the
    proof compressed: 32-byte LE x with the y-parity flag in the top bit
    (identity = all zeros)

Host-side pure Python: transcript traffic is a few KB per proof and
inherently sequential, so it stays off the TPU (SURVEY §2.3 table).
"""
from __future__ import annotations

import hashlib

from ..fields.constants import BN254_FQ, BN254_FR
from ..fields.ref_curve import BN254_G1_CURVE
from ..fields.ref_field import from_bytes_wide, to_le_bytes

PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"
PERSONAL = b"Halo2-Transcript"


def compress_g1(pt) -> bytes:
    """Affine int point (or None) -> 32-byte compressed encoding."""
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(to_le_bytes(x, 32))
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def decompress_g1(b: bytes):
    """32-byte compressed encoding -> affine int point (or None).

    Raises ValueError for non-canonical / off-curve encodings.
    """
    if len(b) != 32:
        raise ValueError("bad point length")
    if b == bytes(32):
        return None
    raw = bytearray(b)
    y_odd = bool(raw[31] & 0x80)
    raw[31] &= 0x7F
    x = int.from_bytes(bytes(raw), "little")
    if x >= BN254_FQ:
        raise ValueError("non-canonical x")
    pt = BN254_G1_CURVE.lift_x(x, y_odd)
    if pt is None:
        raise ValueError("x not on curve")
    return pt


class Blake2bBase:
    def __init__(self):
        self.state = hashlib.blake2b(digest_size=64, person=PERSONAL)

    def common_point(self, pt) -> None:
        # identity absorbs as zero coordinates (halo2curves serializes the
        # identity to all-zero bytes; a zero quotient piece legitimately
        # commits to the identity). DEVIATION from upstream halo2: the PSE
        # Blake2bRead transcript REJECTS points at infinity on read, so a
        # proof containing an identity commitment is not cross-verifiable
        # with the reference verifier. Commitments here are unblinded, so
        # the identity is reachable (e.g. an all-zero column); accepting it
        # keeps prover/verifier self-consistent within this framework.
        x, y = (0, 0) if pt is None else pt
        self.state.update(PREFIX_POINT)
        self.state.update(to_le_bytes(x, 32))
        self.state.update(to_le_bytes(y, 32))

    def common_scalar(self, s: int) -> None:
        self.state.update(PREFIX_SCALAR)
        self.state.update(to_le_bytes(s % BN254_FR, 32))

    def squeeze_challenge(self) -> int:
        self.state.update(PREFIX_CHALLENGE)
        digest = self.state.copy().digest()
        return from_bytes_wide(digest, BN254_FR)


class Blake2bWrite(Blake2bBase):
    """Prover side: absorb + append to the proof byte stream."""

    def __init__(self):
        super().__init__()
        self.proof = bytearray()

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self.proof += compress_g1(pt)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self.proof += to_le_bytes(s % BN254_FR, 32)

    def finalize(self) -> bytes:
        return bytes(self.proof)


class Blake2bRead(Blake2bBase):
    """Verifier side: parse the proof byte stream while re-absorbing."""

    def __init__(self, proof: bytes):
        super().__init__()
        self.proof = proof
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.proof):
            raise ValueError("proof too short")
        out = self.proof[self.off : self.off + n]
        self.off += n
        return out

    def read_point(self):
        pt = decompress_g1(self._take(32))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(32), "little")
        if s >= BN254_FR:
            raise ValueError("non-canonical scalar")
        self.common_scalar(s)
        return s

    def assert_consumed(self) -> None:
        if self.off != len(self.proof):
            raise ValueError("trailing proof bytes")


# ---------------------------------------------------------------------------
# Keccak-256 (EVM) transcript — snark-verifier EvmTranscript equivalent
# (ecdsa_p256.rs:329-377: ProverGWC + EvmTranscript). Points travel
# uncompressed big-endian (x||y, 64 bytes); scalars big-endian 32 bytes;
# squeezing hashes the accumulated buffer and restarts it from the digest.
# ---------------------------------------------------------------------------

from ..utils.keccak import keccak256  # noqa: E402


def encode_g1_evm(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def decode_g1_evm(b: bytes):
    if len(b) != 64:
        raise ValueError("bad evm point length")
    if b == bytes(64):
        return None
    x = int.from_bytes(b[:32], "big")
    y = int.from_bytes(b[32:], "big")
    if x >= BN254_FQ or y >= BN254_FQ:
        raise ValueError("non-canonical evm point")
    pt = (x, y)
    if not BN254_G1_CURVE.is_on_curve(pt):
        raise ValueError("evm point not on curve")
    return pt


class KeccakBase:
    def __init__(self):
        self.buf = bytearray()

    def common_point(self, pt) -> None:
        # identity absorbs/encodes as (0, 0) — the EVM verifier's point
        # check treats the zero word pair as the identity
        self.buf += encode_g1_evm(pt)

    def common_scalar(self, s: int) -> None:
        self.buf += (s % BN254_FR).to_bytes(32, "big")

    def squeeze_challenge(self) -> int:
        digest = keccak256(bytes(self.buf))
        self.buf = bytearray(digest)
        return int.from_bytes(digest, "big") % BN254_FR


class KeccakWrite(KeccakBase):
    def __init__(self):
        super().__init__()
        self.proof = bytearray()

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self.proof += encode_g1_evm(pt)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self.proof += (s % BN254_FR).to_bytes(32, "big")

    def finalize(self) -> bytes:
        return bytes(self.proof)


class KeccakRead(KeccakBase):
    def __init__(self, proof: bytes):
        super().__init__()
        self.proof = proof
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.proof):
            raise ValueError("proof too short")
        out = self.proof[self.off : self.off + n]
        self.off += n
        return out

    def read_point(self):
        pt = decode_g1_evm(self._take(64))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        s = int.from_bytes(self._take(32), "big")
        if s >= BN254_FR:
            raise ValueError("non-canonical scalar")
        self.common_scalar(s)
        return s

    def assert_consumed(self) -> None:
        if self.off != len(self.proof):
            raise ValueError("trailing proof bytes")
