"""CRT big-integer chip: emulated prime-field arithmetic over bn254-Fr.

Equivalent of `halo2-ecc`'s FpConfig CRT chip (SURVEY §2.2): secp256r1
field elements are 3 x 88-bit limbs of Fr cells (the reference's
limb_bits=88 / num_limbs=3 vocabulary). The workhorse is
`product_linear_constrain`, which proves

    sum_i  c_i * A_i * B_i  +  sum_j d_j * X_j  +  const  ===  0   (mod p)

in ONE quotient witness + ONE carry-decomposed integer identity — so a
whole short-Weierstrass formula (e.g. lam*2y - 3x^2 - a = 0) costs a single
carry chain instead of materializing every intermediate. All materialized
values are "proper": limbs range-checked to [88, 88, 80] bits (< 2^256).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import BN254_FR
from .builder import Cell, CircuitBuilder

R = BN254_FR
LIMB_BITS = 88
NUM_LIMBS = 3
TOP_BITS = 256 - 2 * LIMB_BITS  # 80
LIMB_BASE = 1 << LIMB_BITS
CARRY_BOUND_BITS = 100  # |carry| < 2^99, checked shifted into [0, 2^100)


def limbs_of(x: int, n: int = NUM_LIMBS) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & (LIMB_BASE - 1) for i in range(n)]


@dataclass
class CrtInt:
    limbs: list[Cell]  # little-endian, proper (range-checked)
    value: int  # integer value < 2^256


def _signed(v: int) -> int:
    """Interpret an Fr element as a signed integer near zero."""
    return v - R if v > R // 2 else v


class CrtChip:
    """One emulated modulus worth of gadgets (build one per field)."""

    def __init__(self, b: CircuitBuilder, p: int):
        assert p < 1 << 256
        self.b = b
        self.p = p
        self.p_limbs = limbs_of(p)

    # --- loading ---------------------------------------------------------
    def _range_limbs(self, cells: list[Cell]) -> None:
        self.b.range_check(cells[0], LIMB_BITS)
        self.b.range_check(cells[1], LIMB_BITS)
        self.b.range_check(cells[2], TOP_BITS)

    def load(self, x: int) -> CrtInt:
        assert 0 <= x < 1 << 256
        cells = self.b.load_witnesses(limbs_of(x))
        self._range_limbs(cells)
        return CrtInt(cells, x)

    def constant(self, x: int) -> CrtInt:
        assert 0 <= x < 1 << 256
        cells = [self.b.load_constant(v) for v in limbs_of(x)]
        return CrtInt(cells, x)

    def zero(self) -> CrtInt:
        return self.constant(0)

    def one(self) -> CrtInt:
        return self.constant(1)

    # --- integer-identity core -------------------------------------------
    def _carry_chain(self, s_cells: list[Cell]) -> None:
        """Constrain sum_k s_k * 2^(88k) == 0 given |s_k| << 2^(CARRY-1+88).

        Witnesses carries c_k = (s_k + c_{k-1}) / 2^88, range-checks their
        shifted values, and pins the final carry to zero.
        """
        b = self.b
        shift = 1 << (CARRY_BOUND_BITS - 1)
        carry_prev: Cell | None = None
        carry_prev_int = 0
        for k, s_cell in enumerate(s_cells):
            s_int = _signed(s_cell.value)
            total = s_int + carry_prev_int
            lhs = (
                b.add(s_cell, carry_prev) if carry_prev is not None else s_cell
            )
            if k == len(s_cells) - 1:
                assert total == 0, "integer identity does not hold"
                b.assert_zero(lhs)
                return
            assert total % LIMB_BASE == 0, "carry chain witness broken"
            c_int = total // LIMB_BASE
            assert abs(c_int) < 1 << (CARRY_BOUND_BITS - 1), hex(c_int)
            [c_cell] = b.load_witnesses([c_int % R])
            rhs = b.mul_const(c_cell, LIMB_BASE)
            b.assert_equal(lhs, rhs)
            shifted = b.add_const(c_cell, shift)
            b.range_check(shifted, CARRY_BOUND_BITS)
            carry_prev, carry_prev_int = c_cell, c_int

    def product_linear_constrain(
        self,
        prods: list[tuple[int, CrtInt, CrtInt]],
        lins: list[tuple[int, CrtInt]] = (),
        const: int = 0,
    ) -> None:
        """Enforce sum c*A*B + sum d*X + const === 0 (mod p).

        Coefficients c, d are small signed ints (|c| <= 8, |d| <= 8 with up
        to ~8 terms keeps every bound comfortable).
        """
        b = self.b
        p = self.p
        total = (
            sum(c * a.value * bb.value for c, a, bb in prods)
            + sum(d * x.value for d, x in lins)
            + const
        )
        assert total % p == 0, "product_linear witness inconsistent"
        # shift so the witnessed quotient is non-negative:
        # |negative part| < 16 * 2^512 = 2^516  ->  K*p >= 2^516
        K = (1 << 517) // p + 1
        q = (total + K * p) // p
        assert 0 <= q < 1 << 264, "quotient out of the 3-limb range"
        q_cells = b.load_witnesses(limbs_of(q))
        for qc in q_cells:
            b.range_check(qc, LIMB_BITS)
        kp = K * p
        nk = 2 * NUM_LIMBS + 1  # K*p < 2^518 -> 6 limbs + margin
        kp_limbs = limbs_of(kp, nk)
        const_limbs = _signed_limbs(const, nk)

        s_cells = []
        for k in range(nk):
            avs2, bvs2 = [], []
            for c, a, bb in prods:
                for i in range(NUM_LIMBS):
                    j = k - i
                    if 0 <= j < NUM_LIMBS:
                        if c == 1:
                            avs2.append(a.limbs[i])
                            bvs2.append(bb.limbs[j])
                        else:
                            # scale one side: (c * a_i) * b_j via a scaled
                            # intermediate cell
                            sc = self._scaled(a.limbs[i], c)
                            avs2.append(sc)
                            bvs2.append(bb.limbs[j])
            for i in range(NUM_LIMBS):
                j = k - i
                if 0 <= j < NUM_LIMBS:
                    avs2.append(q_cells[i])
                    bvs2.append((-self.p_limbs[j]) % R)
            for d, x in lins:
                if k < NUM_LIMBS:
                    avs2.append(x.limbs[k])
                    bvs2.append(d % R)
            cterm = (kp_limbs[k] + const_limbs[k]) % R
            if avs2:
                ip = b.inner_product(avs2, bvs2)
                s = b.add_const(ip, cterm) if cterm else ip
            else:
                s = b.load_constant(cterm)
            s_cells.append(s)
        self._carry_chain(s_cells)

    _scaled_cache_attr = "_crt_scaled_cache"

    def _scaled(self, cell: Cell, c: int) -> Cell:
        """c * cell as a cell, memoized per (cell, c)."""
        cache = getattr(self.b, self._scaled_cache_attr, None)
        if cache is None:
            cache = {}
            setattr(self.b, self._scaled_cache_attr, cache)
        key = (cell.col, cell.row, c)
        if key not in cache:
            cache[key] = self.b.mul_const(cell, c % R)
        return cache[key]

    # --- derived operations ----------------------------------------------
    def mul_constrain(self, a: CrtInt, bb: CrtInt, out: CrtInt) -> None:
        self.product_linear_constrain([(1, a, bb)], [(-1, out)])

    def mul(self, a: CrtInt, bb: CrtInt) -> CrtInt:
        out = self.load(a.value * bb.value % self.p)
        self.mul_constrain(a, bb, out)
        return out

    def square(self, a: CrtInt) -> CrtInt:
        return self.mul(a, a)

    def linear_constrain(self, terms: list[tuple[int, CrtInt]], out: CrtInt,
                         kmax_bits: int = 16) -> None:
        """Pure-linear fast path: single-cell quotient."""
        b = self.b
        p = self.p
        total = sum(c * a.value for c, a in terms) - out.value
        K = 1 << (kmax_bits - 1)
        q = (total + K * p) // p
        assert (total + K * p) % p == 0, "linear witness broken"
        assert 0 <= q < 1 << kmax_bits
        [q_cell] = b.load_witnesses([q])
        b.range_check(q_cell, kmax_bits)
        kp_limbs = limbs_of(K * p, NUM_LIMBS + 1)

        s_cells = []
        for k in range(NUM_LIMBS):
            avs, bvs = [], []
            for c, a in terms:
                avs.append(a.limbs[k])
                bvs.append(c % R)
            avs.append(q_cell)
            bvs.append((-self.p_limbs[k]) % R)
            avs.append(out.limbs[k])
            bvs.append(R - 1)
            ip = b.inner_product(avs, bvs)
            s = b.add_const(ip, kp_limbs[k])
            s_cells.append(s)
        s_cells.append(b.load_constant(kp_limbs[NUM_LIMBS]))
        self._carry_chain(s_cells)

    def add(self, a: CrtInt, bb: CrtInt) -> CrtInt:
        out = self.load((a.value + bb.value) % self.p)
        self.linear_constrain([(1, a), (1, bb)], out)
        return out

    def sub(self, a: CrtInt, bb: CrtInt) -> CrtInt:
        out = self.load((a.value - bb.value) % self.p)
        self.linear_constrain([(1, a), (-1, bb)], out)
        return out

    def mul_small(self, a: CrtInt, c: int) -> CrtInt:
        out = self.load(c * a.value % self.p)
        self.linear_constrain([(c, a)], out)
        return out

    def constrain_equal_mod(self, a: CrtInt, bb: CrtInt) -> None:
        self.linear_constrain([(1, a), (-1, bb)], self.zero())

    def assert_nonzero_mod(self, a: CrtInt) -> CrtInt:
        """Witness a modular inverse (returned): possible iff a !== 0."""
        inv = pow(a.value % self.p, -1, self.p)
        w = self.load(inv)
        self.product_linear_constrain([(1, a, w)], [], -1)
        return w

    def div(self, num: CrtInt, den: CrtInt) -> CrtInt:
        """Witness w = num/den; constrain den*w === num (den nonzero)."""
        w_val = num.value % self.p * pow(den.value % self.p, -1, self.p) % self.p
        w = self.load(w_val)
        self.product_linear_constrain([(1, den, w)], [(-1, num)])
        return w

    def enforce_canonical(self, a: CrtInt) -> None:
        """a < p (exact integer comparison via borrow-free decomposition)."""
        diff = self.p - 1 - a.value
        assert diff >= 0, "witness not canonical"
        d = self.load(diff)
        pm1 = limbs_of(self.p - 1)
        b = self.b
        s_cells = []
        for k in range(NUM_LIMBS):
            s = b.add(a.limbs[k], d.limbs[k])
            s = b.add_const(s, (-pm1[k]) % R)
            s_cells.append(s)
        self._carry_chain(s_cells)

    def select(self, cond: Cell, a: CrtInt, bb: CrtInt) -> CrtInt:
        cells = [
            self.b.select(cond, la, lb) for la, lb in zip(a.limbs, bb.limbs)
        ]
        val = a.value if cond.value else bb.value
        return CrtInt(cells, val)


def _signed_limbs(x: int, n: int) -> list[int]:
    """Limb decomposition of a signed constant (mod R per limb)."""
    if x >= 0:
        out = limbs_of(x, n)
    else:
        out = [(-v) % R for v in limbs_of(-x, n)]
    return out
