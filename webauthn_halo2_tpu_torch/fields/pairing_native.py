"""ctypes binding of the host's bn254 pairing check and G1 MSM
(csrc/host/pairing.cpp, built at first use by utils/host_build.py).

Points cross the boundary as plain (non-Montgomery) little-endian 4x64-bit
limbs, coordinates reduced mod q and scalars mod r; infinity is the
all-zero sentinel on input and output. A library that does not build
raises: the pure-Python tower (fields/pairing.pairing_check_py) is the
tests' oracle, not a fallback.
"""
from __future__ import annotations

import ctypes

from ..utils import host_build
from .constants import BN254_FQ, BN254_FR


def _words(values, count: int) -> ctypes.Array:
    raw = b"".join((v % BN254_FQ).to_bytes(32, "little") for v in values)
    return (ctypes.c_uint64 * (4 * count)).from_buffer_copy(raw)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1. pairs = [(G1 | None, G2)], with G1 = (x, y)
    ints and G2 = ((x0, x1), (y0, y1)) ints; a None G1 is skipped."""
    lib = host_build.load("pairing")
    live = [(p, q) for p, q in pairs if p is not None]
    n = len(live)
    g1 = _words([c for p, _ in live for c in p], 2 * n)
    g2 = _words([c for _, ((x0, x1), (y0, y1)) in live for c in (x0, x1, y0, y1)], 4 * n)
    rc = lib.wh2_pairing_check(g1, g2, n)
    if rc < 0:
        raise ValueError("the native pairing check refused its input")
    return bool(rc)


def g1_msm(pairs):
    """sum s_i * P_i over G1. pairs = [(P | None, scalar int)]. Returns
    affine (x, y) ints, None for the point at infinity."""
    lib = host_build.load("pairing")
    live = [(p, s % BN254_FR) for p, s in pairs if p is not None and s % BN254_FR]
    n = len(live)
    if n == 0:
        return None
    sc = (ctypes.c_uint64 * (4 * n)).from_buffer_copy(
        b"".join(s.to_bytes(32, "little") for _, s in live))
    pts = _words([c for p, _ in live for c in p], 2 * n)
    out = (ctypes.c_uint64 * 8)()
    lib.wh2_g1_msm(sc, pts, n, out)
    raw = bytes(out)
    x = int.from_bytes(raw[:32], "little")
    y = int.from_bytes(raw[32:], "little")
    return None if x == 0 and y == 0 else (x, y)
