"""Plain integer arithmetic for the benchmark's reference: the bn254 scalar
field and G1, and NIST P-256 with textbook ECDSA.

Written from the public curve standards for this harness; it imports
nothing of the program under test. Points are affine (x, y) int pairs, None
for the point at infinity; multiplication runs in Jacobian coordinates.
"""
from __future__ import annotations

import hashlib

# bn254 (alt_bn128): base field q, scalar field r, G1: y^2 = x^3 + 3
BN_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN_G1 = (1, 2)
BN_B = 3
# Fr: multiplicative generator 7, r - 1 = 2^28 * t
FR_GENERATOR = 7
FR_TWO_ADICITY = 28
FR_DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, BN_R)

# NIST P-256 (FIPS 186-4, D.1.2.3)
P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_A = P256_P - 3
P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
P256_G = (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
          0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5)


def root_of_unity(k: int) -> int:
    """The primitive 2^k-th root of unity g^((r - 1) / 2^k) of Fr."""
    return pow(FR_GENERATOR, (BN_R - 1) >> k, BN_R)


def batch_inv(vals: list, m: int) -> list:
    """Inverses of nonzero `vals` mod m with one exponentiation."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % m
    inv = pow(prefix[-1], m - 2, m)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % m
        inv = inv * vals[i] % m
    return out


class Curve:
    """y^2 = x^3 + a x + b over GF(p)."""

    def __init__(self, p: int, a: int, b: int):
        self.p, self.a, self.b = p, a, b

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.a * x - self.b) % self.p == 0

    def _dbl(self, X, Y, Z):
        p = self.p
        if Z == 0 or Y == 0:
            return 1, 1, 0
        YY = Y * Y % p
        S = 4 * X * YY % p
        ZZ = Z * Z % p
        M = (3 * X * X + self.a * ZZ * ZZ) % p
        X3 = (M * M - 2 * S) % p
        Y3 = (M * (S - X3) - 8 * YY * YY) % p
        return X3, Y3, 2 * Y * Z % p

    def _add(self, P, Q):
        p = self.p
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        if Z1 == 0:
            return Q
        if Z2 == 0:
            return P
        Z1Z1, Z2Z2 = Z1 * Z1 % p, Z2 * Z2 % p
        U1, U2 = X1 * Z2Z2 % p, X2 * Z1Z1 % p
        S1, S2 = Y1 * Z2 * Z2Z2 % p, Y2 * Z1 * Z1Z1 % p
        if U1 == U2:
            return self._dbl(*P) if S1 == S2 else (1, 1, 0)
        H, rr = (U2 - U1) % p, (S2 - S1) % p
        HH = H * H % p
        HHH = H * HH % p
        V = U1 * HH % p
        X3 = (rr * rr - HHH - 2 * V) % p
        Y3 = (rr * (V - X3) - S1 * HHH) % p
        return X3, Y3, Z1 * Z2 * H % p

    def _affine(self, P):
        X, Y, Z = P
        if Z == 0:
            return None
        zi = pow(Z, self.p - 2, self.p)
        zi2 = zi * zi % self.p
        return X * zi2 % self.p, Y * zi2 * zi % self.p

    @staticmethod
    def _jac(pt):
        return (1, 1, 0) if pt is None else (pt[0], pt[1], 1)

    def add(self, a, b):
        return self._affine(self._add(self._jac(a), self._jac(b)))

    def mul(self, k: int, pt):
        acc, base = (1, 1, 0), self._jac(pt)
        while k > 0:
            if k & 1:
                acc = self._add(acc, base)
            base = self._dbl(*base)
            k >>= 1
        return self._affine(acc)

    def msm(self, pairs, order: int):
        """sum of s * P over (P, s) pairs, scalars taken mod `order`."""
        acc = (1, 1, 0)
        for pt, s in pairs:
            s %= order
            if s and pt is not None:
                acc = self._add(acc, self._jac(self.mul(s, pt)))
        return self._affine(acc)

    def lift_x(self, x: int, y_odd: bool):
        """The point with abscissa x and the given parity of y (p = 3 mod 4),
        None if there is none."""
        y2 = (x * x * x + self.a * x + self.b) % self.p
        y = pow(y2, (self.p + 1) // 4, self.p)
        if y * y % self.p != y2:
            return None
        if (y & 1) != int(y_odd):
            y = self.p - y
        return x, y


BN_G1_CURVE = Curve(BN_Q, 0, BN_B)
P256 = Curve(P256_P, P256_A, P256_B)


class SeededStream:
    """Deterministic bytes from a label: SHA-256 in counter mode."""

    def __init__(self, *label):
        self.key = repr(label).encode()
        self.ctr = 0

    def randbelow(self, m: int) -> int:
        while True:
            h = hashlib.sha256(self.key + self.ctr.to_bytes(8, "little")).digest()
            h += hashlib.sha256(h).digest()
            self.ctr += 1
            v = int.from_bytes(h, "little") >> (512 - m.bit_length())
            if v < m:
                return v


def ecdsa_request(seed: int, stream: str, index: int) -> dict:
    """One signing request of the traffic, as the program's ProveRequestBody
    carries it (r, s, pubkey_x, pubkey_y, msghash as 32-byte little-endian
    lists): a new P-256 key, message and nonce drawn uniformly from (seed,
    stream, index), and the textbook signature."""
    rng = SeededStream("ecdsa-request", seed, stream, index)
    while True:
        sk = 1 + rng.randbelow(P256_N - 1)
        m = rng.randbelow(P256_N)
        k = 1 + rng.randbelow(P256_N - 1)
        R = P256.mul(k, P256_G)
        r = R[0] % P256_N
        s = pow(k, -1, P256_N) * (m + r * sk) % P256_N
        if r and s:
            break
    pub = P256.mul(sk, P256_G)
    return {name: list(int(v).to_bytes(32, "little"))
            for name, v in zip(("r", "s", "pubkey_x", "pubkey_y", "msghash"),
                               (r, s, pub[0], pub[1], m))}


def ecdsa_valid(req: dict) -> bool:
    """Textbook ECDSA-P256 verification of a request's signature."""
    r, s, x, y, m = (int.from_bytes(bytes(req[k]), "little")
                     for k in ("r", "s", "pubkey_x", "pubkey_y", "msghash"))
    if not (0 < r < P256_N and 0 < s < P256_N) or not P256.on_curve((x, y)):
        return False
    w = pow(s, -1, P256_N)
    R = P256.add(P256.mul(m * w % P256_N, P256_G), P256.mul(r * w % P256_N, (x, y)))
    return R is not None and R[0] % P256_N == r
