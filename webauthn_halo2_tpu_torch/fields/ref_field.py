"""Host-side (pure Python int) reference modular arithmetic.

This is the conformance oracle for the JAX/Pallas limb kernels and the
engine for cold-path host work (transcript field decoding, pairing-based
verification, witness scalar math). Mirrors the role `halo2curves` plays for
the reference (SURVEY §2.2), implemented from first principles.
"""
from __future__ import annotations


def inv_mod(a: int, m: int) -> int:
    """Modular inverse via extended Euclid. Raises ZeroDivisionError on 0."""
    a %= m
    if a == 0:
        raise ZeroDivisionError("inverse of 0")
    return pow(a, -1, m)


def sqrt_mod(a: int, p: int) -> int | None:
    """Square root mod an odd prime p, or None if a is a non-residue.

    Tonelli–Shanks; fast path for p ≡ 3 (mod 4).
    """
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli–Shanks
    s, q = 0, p - 1
    while q % 2 == 0:
        s += 1
        q //= 2
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def to_le_bytes(x: int, length: int = 32) -> bytes:
    return int(x).to_bytes(length, "little")


def from_le_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


def from_bytes_wide(b: bytes, m: int) -> int:
    """64-byte little-endian value reduced mod m (halo2 `from_bytes_wide`)."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % m


def batch_inv(vals: list[int], m: int) -> list[int]:
    """Montgomery batch inversion. Zero maps to zero (halo2 convention)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % m
    inv = inv_mod(prefix[n], m)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v == 0:
            out[i] = 0
        else:
            out[i] = prefix[i] * inv % m
            inv = inv * v % m
    return out
