"""bn254 optimal-ate pairing (host-side).

Used only on the cold path: KZG pairing checks in the local verifier and
the in-repo EVM's precompile (proof generation needs no pairings, so this
never touches the card). `pairing_check` runs in the native tower
(csrc/host/pairing.cpp through fields/pairing_native.py); the pure-Python
tower below, `pairing_check_py`, is the tests' oracle for it.

Construction: Fq12 = Fq[w]/(w^12 - 18 w^6 + 82), with Fq2 embedded via
i = w^6 - 9 (i^2 = -1). G2 lives on the D-twist y^2 = x^3 + 3/(9+i); points
are untwisted into Fq12 as (x * w^2, y * w^3). Standard public math
(BN curves, Barreto–Naehrig), implemented from the definitions.
"""
from __future__ import annotations

from . import pairing_native
from .constants import BN254_FQ as Q
from .constants import BN254_FR, BN254_X
from .ref_field import inv_mod

# ate loop count = 6x + 2
ATE_LOOP_COUNT = 6 * BN254_X + 2

# Fq12 modulus: w^12 - 18 w^6 + 82  (so (w^6 - 9)^2 = -1)
_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # constant..degree-11


class Fq12:
    """Element of Fq12 as a degree-<12 polynomial in w over Fq."""

    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == 12
        self.c = tuple(x % Q for x in coeffs)

    @staticmethod
    def one() -> "Fq12":
        return Fq12((1,) + (0,) * 11)

    @staticmethod
    def zero() -> "Fq12":
        return Fq12((0,) * 12)

    @staticmethod
    def from_fq(x: int) -> "Fq12":
        return Fq12((x,) + (0,) * 11)

    @staticmethod
    def from_fq2(x0: int, x1: int) -> "Fq12":
        """Embed x0 + x1*i with i = w^6 - 9."""
        c = [0] * 12
        c[0] = (x0 - 9 * x1) % Q
        c[6] = x1 % Q
        return Fq12(c)

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self) -> "Fq12":
        return Fq12([-a for a in self.c])

    def __mul__(self, o) -> "Fq12":
        if isinstance(o, int):
            return Fq12([a * o for a in self.c])
        a, b = self.c, o.c
        t = [0] * 23
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    t[i + j] += ai * bj
        # reduce degree 22..12 using w^12 = 18 w^6 - 82
        for d in range(22, 11, -1):
            hi = t[d]
            if hi:
                t[d] = 0
                t[d - 6] += 18 * hi
                t[d - 12] -= 82 * hi
        return Fq12(t[:12])

    def square(self) -> "Fq12":
        return self * self

    def inv(self) -> "Fq12":
        """Extended Euclid over Fq[w] modulo the tower polynomial."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [x % Q for x in _MOD_COEFFS] + [1]

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i] % Q:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            binv = inv_mod(b[degb], Q)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % Q
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % Q
            return [x % Q for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        c0_inv = inv_mod(low[0], Q)
        return Fq12([x * c0_inv for x in lm[:12]])

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c == o.c

    def is_one(self) -> bool:
        return self.c == (1,) + (0,) * 11


# Points in G1-embedded-in-Fq12 space: (Fq12, Fq12) affine, None = infinity
FPoint = tuple[Fq12, Fq12] | None


def twist(q_pt: tuple[tuple[int, int], tuple[int, int]]) -> tuple[Fq12, Fq12]:
    """Untwist a G2 point ((x0,x1),(y0,y1)) into E(Fq12): (x*w^2, y*w^3)."""
    (x0, x1), (y0, y1) = q_pt
    x = Fq12.from_fq2(x0, x1)
    y = Fq12.from_fq2(y0, y1)
    w2 = Fq12((0, 0, 1) + (0,) * 9)
    w3 = Fq12((0, 0, 0, 1) + (0,) * 8)
    return (x * w2, y * w3)


def cast_g1(p: tuple[int, int]) -> tuple[Fq12, Fq12]:
    return (Fq12.from_fq(p[0]), Fq12.from_fq(p[1]))


def _double(pt: FPoint) -> FPoint:
    if pt is None:
        return None
    x, y = pt
    lam = x.square() * 3 * y.inv() * inv_mod(2, Q)
    newx = lam.square() - x * 2
    newy = lam * (x - newx) - y
    return (newx, newy)


def _add(p1: FPoint, p2: FPoint) -> FPoint:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    if x1 == x2:
        return None
    lam = (y2 - y1) * (x2 - x1).inv()
    newx = lam.square() - x1 - x2
    newy = lam * (x1 - newx) - y1
    return (newx, newy)


def _linefunc(p1, p2, t) -> Fq12:
    """Evaluate the line through p1,p2 at point t (all in E(Fq12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1.c != x2.c:
        lam = (y2 - y1) * (x2 - x1).inv()
        return lam * (xt - x1) - (yt - y1)
    elif y1.c == y2.c:
        lam = x1.square() * 3 * (y1 * 2).inv()
        return lam * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def _frob_fq2(x0: int, x1: int) -> tuple[int, int]:
    """Frobenius x -> x^q on Fq2 (conjugation)."""
    return (x0, (-x1) % Q)


def miller_loop(
    q_pt: tuple[tuple[int, int], tuple[int, int]],
    p_pt: tuple[int, int],
) -> Fq12:
    """Optimal-ate Miller loop f_{6x+2,Q}(P) with the two Frobenius lines."""
    Qp = twist(q_pt)
    P = cast_g1(p_pt)
    R = Qp
    f = Fq12.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(R, R, P)
        R = _double(R)
        if (ATE_LOOP_COUNT >> i) & 1:
            f = f * _linefunc(R, Qp, P)
            R = _add(R, Qp)
    # Frobenius endomorphism lines: Q1 = pi(Q), Q2 = -pi^2(Q)
    (x0, x1), (y0, y1) = q_pt
    # pi on the twist: (x,y) -> (conj(x) * xi^((q-1)/3), conj(y) * xi^((q-1)/2))
    # with xi = 9 + i.  Work in Fq12 coordinates instead (simpler): apply
    # coefficient-wise Frobenius to the untwisted point.
    def frob12(e: Fq12, power: int = 1) -> Fq12:
        # w^q = w * w^(q-1); precompute gamma = w^(q-1) as Fq12
        out = e
        for _ in range(power):
            out = Fq12([pow_c for pow_c in _frob12_coeffs(out)])
        return out

    def _frob12_coeffs(e: Fq12):
        # x -> x^q is linear over Fq; apply to each basis monomial w^k:
        # (w^k)^q = w^(kq) reduced. Precompute basis images once.
        global _FROB_BASIS
        if _FROB_BASIS is None:
            basis = []
            for k in range(12):
                mono = [0] * 12
                mono[k] = 1
                basis.append(Fq12(mono).pow(Q))
            _FROB_BASIS = basis
        acc = [0] * 12
        for k, ck in enumerate(e.c):
            if ck:
                img = _FROB_BASIS[k]
                for j in range(12):
                    acc[j] += ck * img.c[j]
        return [a % Q for a in acc]

    Q1 = (frob12(Qp[0]), frob12(Qp[1]))
    nQ2 = (frob12(Q1[0]), -frob12(Q1[1]))
    f = f * _linefunc(R, Q1, P)
    R = _add(R, Q1)
    f = f * _linefunc(R, nQ2, P)
    return f


_FROB_BASIS = None


def final_exponentiate(f: Fq12) -> Fq12:
    return f.pow((Q**12 - 1) // BN254_FR)


def pairing(q_pt, p_pt) -> Fq12:
    """e(P, Q) with P in G1, Q in G2 (affine int tuples)."""
    return final_exponentiate(miller_loop(q_pt, p_pt))


def pairing_check(pairs: list[tuple[tuple[int, int], tuple]]) -> bool:
    """prod e(P_i, Q_i) == 1 in the native tower (built at first use; a
    failed build raises). `pairs` = [(G1_point, G2_point), ...]; None G1
    entries are skipped (identity contributes 1 to the product)."""
    return pairing_native.pairing_check(pairs)


def pairing_check_py(pairs: list[tuple[tuple[int, int], tuple]]) -> bool:
    """pairing_check in pure Python, via multi-Miller + one final
    exponentiation: the oracle the native tower is held against."""
    f = Fq12.one()
    for p_pt, q_pt in pairs:
        if p_pt is None:
            continue
        f = f * miller_loop(q_pt, p_pt)
    return final_exponentiate(f).is_one()
