"""Host-side short-Weierstrass curve arithmetic + ECDSA (pure Python ints).

Reference oracle for the vectorized JAX curve kernels, and the in-test
fixture generator (random P-256 keypair + signature), mirroring the
reference's self-contained test pattern (ecdsa_p256.rs:222-234).

Points are affine tuples (x, y) with None = point at infinity.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from .constants import (
    BN254_B,
    BN254_FQ,
    BN254_FR,
    BN254_G1,
    P256_A,
    P256_B,
    P256_G,
    P256_N,
    P256_P,
)
from .ref_field import inv_mod, sqrt_mod

Point = tuple[int, int] | None


@dataclass(frozen=True)
class Curve:
    """y^2 = x^3 + a*x + b over GF(p), group order n, generator g."""

    p: int
    a: int
    b: int
    n: int
    g: tuple[int, int]

    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def add(self, p1: Point, p2: Point) -> Point:
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        p = self.p
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * inv_mod(2 * y1, p) % p
        else:
            lam = (y2 - y1) * inv_mod(x2 - x1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg(self, pt: Point) -> Point:
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.p)

    def mul(self, k: int, pt: Point) -> Point:
        """Scalar multiply — Jacobian double-and-add (ONE field inversion
        total; the affine ladder paid an inv_mod per add, which made the
        host verifier's multiopen MSM ~10x slower than necessary)."""
        k %= self.n
        if k == 0 or pt is None:
            return None
        p = self.p
        a = self.a
        x2, y2 = pt
        X, Y, Z = 0, 1, 0  # infinity
        for bit in bin(k)[2:]:
            # double (general a; handles infinity via Z == 0)
            if Z:
                YY = Y * Y % p
                S = 4 * X * YY % p
                ZZ = Z * Z % p
                M = (3 * X * X + a * ZZ % p * ZZ) % p
                X3 = (M * M - 2 * S) % p
                Y3 = (M * (S - X3) - 8 * YY * YY) % p
                Z3 = 2 * Y * Z % p
                X, Y, Z = X3, Y3, Z3
            if bit == "1":
                if Z == 0:
                    X, Y, Z = x2, y2, 1
                else:
                    ZZ = Z * Z % p
                    U2 = x2 * ZZ % p
                    S2 = y2 * ZZ % p * Z % p
                    H = (U2 - X) % p
                    r = (S2 - Y) % p
                    if H == 0:
                        if r == 0:
                            # doubling case: rare (k*P hits 2Q); reuse the
                            # doubling formulas
                            YY = Y * Y % p
                            S = 4 * X * YY % p
                            M = (3 * X * X + a * (Z * Z % p) ** 2) % p
                            X3 = (M * M - 2 * S) % p
                            Y3 = (M * (S - X3) - 8 * YY * YY) % p
                            Z3 = 2 * Y * Z % p
                            X, Y, Z = X3, Y3, Z3
                        else:
                            X, Y, Z = 0, 1, 0
                    else:
                        HH = H * H % p
                        HHH = HH * H % p
                        V = X * HH % p
                        X3 = (r * r - HHH - 2 * V) % p
                        Y3 = (r * (V - X3) - Y * HHH) % p
                        Z3 = Z * H % p
                        X, Y, Z = X3, Y3, Z3
        if Z == 0:
            return None
        zi = inv_mod(Z, p)
        zi2 = zi * zi % p
        return (X * zi2 % p, Y * zi2 % p * zi % p)

    def lift_x(self, x: int, y_odd: bool) -> Point:
        """Decompress: recover (x, y) with given y parity; None if invalid."""
        y2 = (x * x * x + self.a * x + self.b) % self.p
        y = sqrt_mod(y2, self.p)
        if y is None:
            return None
        if (y & 1) != int(y_odd):
            y = self.p - y
        return (x, y)

    def random_point(self) -> tuple[int, int]:
        return self.mul(1 + secrets.randbelow(self.n - 1), self.g)  # type: ignore


BN254_G1_CURVE = Curve(p=BN254_FQ, a=0, b=BN254_B, n=BN254_FR, g=BN254_G1)
P256_CURVE = Curve(p=P256_P, a=P256_A, b=P256_B, n=P256_N, g=P256_G)


# ---------------------------------------------------------------------------
# ECDSA over P-256 (the statement the circuit proves; ecdsa_p256.rs:527-540)
# ---------------------------------------------------------------------------

def ecdsa_keygen(rng=secrets) -> tuple[int, tuple[int, int]]:
    sk = 1 + rng.randbelow(P256_N - 1)
    pk = P256_CURVE.mul(sk, P256_G)
    assert pk is not None
    return sk, pk


def ecdsa_sign(msghash: int, sk: int, k: int | None = None) -> tuple[int, int]:
    """Textbook ECDSA: r = x(kG) mod n, s = k^-1 (m + r*sk) mod n."""
    n = P256_N
    m = msghash % n
    while True:
        kk = k if k is not None else 1 + secrets.randbelow(n - 1)
        R = P256_CURVE.mul(kk, P256_G)
        assert R is not None
        r = R[0] % n
        s = inv_mod(kk, n) * (m + r * sk) % n
        if r != 0 and s != 0:
            return r, s
        if k is not None:
            raise ValueError("bad fixed nonce")


def ecdsa_verify(msghash: int, r: int, s: int, pk: tuple[int, int]) -> bool:
    """Host verify: u1 = m/s, u2 = r/s, R' = u1*G + u2*Q, check x(R') ≡ r.

    Same math the in-circuit gadget enforces
    (ecdsa_verify_no_pubkey_check, ecdsa_p256.rs:169-181).
    """
    n = P256_N
    if not (0 < r < n and 0 < s < n):
        return False
    if not P256_CURVE.is_on_curve(pk) or pk is None:
        return False
    m = msghash % n
    sinv = inv_mod(s, n)
    u1 = m * sinv % n
    u2 = r * sinv % n
    R = P256_CURVE.add(P256_CURVE.mul(u1, P256_G), P256_CURVE.mul(u2, pk))
    if R is None:
        return False
    return R[0] % n == r


def sha256_int(data: bytes) -> int:
    """SHA-256 digest as a big-endian integer (WebAuthn msghash)."""
    return int.from_bytes(hashlib.sha256(data).digest(), "big")


def webauthn_msghash(authenticator_data: bytes, client_data_json: bytes) -> int:
    """msghash = SHA256(authData || SHA256(clientDataJSON)) (index.tsx:186-197)."""
    inner = hashlib.sha256(client_data_json).digest()
    return sha256_int(authenticator_data + inner)
