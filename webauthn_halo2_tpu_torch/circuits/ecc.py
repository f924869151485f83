"""Non-native elliptic-curve chip over the CRT bigint chip.

Equivalent of `halo2-ecc`'s EccChip (SURVEY §2.2): affine P-256 points with
witnessed slopes, strict unequal additions (x-difference proved invertible),
4-bit windowed fixed-base and variable-base scalar multiplication using the
(digit+1) offset trick to keep every table entry and partial sum away from
the identity.

Completeness caveat (shared with the reference's gadget stack): strict
adds require x1 != x2; for honest inputs a collision happens only with
negligible probability over the auxiliary-point/window structure.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import BN254_FR
from ..fields.ref_curve import Curve
from .bigint import CrtChip, CrtInt
from .builder import Cell, CircuitBuilder

R = BN254_FR


@dataclass
class EcPoint:
    x: CrtInt
    y: CrtInt

    @property
    def ints(self):
        return (self.x.value, self.y.value)


class EccChip:
    def __init__(self, b: CircuitBuilder, fp: CrtChip, curve: Curve):
        self.b = b
        self.fp = fp  # coordinate field chip (mod p)
        self.curve = curve

    def load_point(self, pt: tuple[int, int], check: bool = True) -> EcPoint:
        x = self.fp.load(pt[0])
        y = self.fp.load(pt[1])
        p = EcPoint(x, y)
        if check:
            self.assert_on_curve(p)
        return p

    def constant_point(self, pt: tuple[int, int]) -> EcPoint:
        return EcPoint(self.fp.constant(pt[0]), self.fp.constant(pt[1]))

    def assert_on_curve(self, p: EcPoint) -> None:
        """x^3 + a x + b - y^2 === 0 (mod p), one materialized square."""
        fp = self.fp
        cp = self.curve.p
        a_int = self.curve.a % cp
        assert a_int in (0, cp - 3), "only a = 0 / a = -3 curves supported"
        a_coef = 0 if a_int == 0 else -3
        x2 = fp.square(p.x)
        lins = [(a_coef, p.x)] if a_coef else []
        fp.product_linear_constrain(
            [(1, x2, p.x), (-1, p.y, p.y)], lins, self.curve.b % cp
        )

    def add_unequal(self, p: EcPoint, q: EcPoint, strict: bool = True
                    ) -> EcPoint:
        """p + q with witnessed slope; requires x1 != x2 (proved if strict).

        Each curve equation is one product_linear constraint; only the
        slope and the result coordinates are materialized.
        """
        fp = self.fp
        cp = self.curve.p
        dx = (q.x.value - p.x.value) % cp
        dy = (q.y.value - p.y.value) % cp
        if strict:
            w = fp.load(pow(dx, -1, cp))
            # w*(x2 - x1) - 1 === 0  => x1 != x2
            fp.product_linear_constrain(
                [(1, w, q.x), (-1, w, p.x)], [], -1
            )
        lam_v = dy * pow(dx, -1, cp) % cp
        lam = fp.load(lam_v)
        # lam*(x2-x1) - (y2-y1) === 0
        fp.product_linear_constrain(
            [(1, lam, q.x), (-1, lam, p.x)], [(-1, q.y), (1, p.y)]
        )
        x3 = fp.load((lam_v * lam_v - p.x.value - q.x.value) % cp)
        fp.product_linear_constrain(
            [(1, lam, lam)], [(-1, p.x), (-1, q.x), (-1, x3)]
        )
        y3 = fp.load((lam_v * (p.x.value - x3.value) - p.y.value) % cp)
        fp.product_linear_constrain(
            [(1, lam, p.x), (-1, lam, x3)], [(-1, p.y), (-1, y3)]
        )
        return EcPoint(x3, y3)

    def double(self, p: EcPoint) -> EcPoint:
        """2p: 2*lam*y - 3x^2 - a === 0, then the chord equations."""
        fp = self.fp
        cp = self.curve.p
        a_int = self.curve.a % cp
        a_signed = 0 if a_int == 0 else a_int - cp  # -3 for P-256
        lam_v = (
            (3 * p.x.value * p.x.value + a_int)
            * pow(2 * p.y.value % cp, -1, cp)
        ) % cp
        lam = fp.load(lam_v)
        fp.product_linear_constrain(
            [(2, lam, p.y), (-3, p.x, p.x)], [], -a_signed
        )
        x3 = fp.load((lam_v * lam_v - 2 * p.x.value) % cp)
        fp.product_linear_constrain([(1, lam, lam)], [(-2, p.x), (-1, x3)])
        y3 = fp.load((lam_v * (p.x.value - x3.value) - p.y.value) % cp)
        fp.product_linear_constrain(
            [(1, lam, p.x), (-1, lam, x3)], [(-1, p.y), (-1, y3)]
        )
        return EcPoint(x3, y3)

    def select(self, cond: Cell, p: EcPoint, q: EcPoint) -> EcPoint:
        return EcPoint(self.fp.select(cond, p.x, q.x),
                       self.fp.select(cond, p.y, q.y))

    def mux(self, indicators: list[Cell], pts: list[EcPoint]) -> EcPoint:
        """sum_i ind_i * pts_i with exactly one indicator == 1.

        Cheap inner-product multiplexer over each limb.
        """
        b = self.b
        fp = self.fp
        sel = next(i for i, ind in enumerate(indicators) if ind.value == 1)
        out_limbs = []
        for coord in range(2):
            for l_i in range(3):
                cells = [
                    (pt.x if coord == 0 else pt.y).limbs[l_i] for pt in pts
                ]
                out_limbs.append(b.inner_product(indicators, cells))
        x = CrtInt(out_limbs[0:3], pts[sel].x.value)
        y = CrtInt(out_limbs[3:6], pts[sel].y.value)
        return EcPoint(x, y)

    def digit_indicators(self, digit: Cell, width: int) -> list[Cell]:
        """One-hot indicators ind_i = (digit == i) via a bit-product tree.

        Also fully constrains digit in [0, 2^width) (bit decomposition),
        so callers may skip a separate range check on the digit cell.
        """
        b = self.b
        bits = [(digit.value >> i) & 1 for i in range(width)]
        bit_cells = b.load_witnesses(bits)
        for c in bit_cells:
            b.assert_bit(c)
        recomposed = b.inner_product(bit_cells, [1 << i for i in range(width)])
        b.assert_equal(recomposed, digit)
        one = b.load_constant(1)
        level = [b.sub(one, bit_cells[0]), bit_cells[0]]
        for bit in bit_cells[1:]:
            nbit = b.sub(one, bit)
            # order: index i = sum bits 2^j -> low bits vary fastest
            nxt = [b.mul(hi, lo) for hi in (nbit, bit) for lo in level]
            level = nxt
        return level
