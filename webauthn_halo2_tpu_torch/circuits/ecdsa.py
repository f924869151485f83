"""In-circuit ECDSA-P256 verification gadget.

Equivalent of `halo2-ecc`'s `ecdsa_verify_no_pubkey_check` with 4-bit
fixed/variable windows (reference call: ecdsa_p256.rs:169-181, window args
(4, 4)). Statement: given witnesses (r, s, msghash, pk), the P-256 ECDSA
verification equation holds:

    u1 = m s^-1,  u2 = r s^-1  (mod n),
    R' = u1 G + u2 pk,   x(R') === r (mod n),  0 < r, s < n.

Scalar multiplications use the (digit+1) offset: each 4-bit window selects
from a 16-entry table of (i+1)-multiples, and the digit stream is
constrained to encode u' = u - sum_w 16^w (mod n), so no table entry or
honest partial sum is the identity and the result is exactly u * P.
"""
from __future__ import annotations

import functools

from ..fields.constants import BN254_FR, P256_N, P256_P
from ..fields.ref_curve import P256_CURVE, Curve
from .bigint import LIMB_BASE, LIMB_BITS, CrtChip, CrtInt, limbs_of
from .builder import Cell, CircuitBuilder
from .ecc import EccChip, EcPoint

R = BN254_FR
WINDOW = 4
NUM_WINDOWS = 64  # 256 bits / 4
C0 = ((1 << 256) - 1) // 15  # sum_{w<64} 16^w
DIGITS_PER_LIMB = LIMB_BITS // WINDOW  # 22


@functools.lru_cache(maxsize=4)
def _fixed_base_tables(curve: Curve) -> tuple:
    """Constant tables FT[w][i] = ((i+1) * 16^w mod n) * G (host ints)."""
    tables = []
    base = curve.g
    for w in range(NUM_WINDOWS):
        row = []
        acc = base
        for i in range(16):
            row.append(acc)
            acc = curve.add(acc, base)
        tables.append(row)
        # base <- 16 * base
        for _ in range(WINDOW):
            base = curve.add(base, base)
    return tuple(tuple(r) for r in tables)


class EcdsaChip:
    def __init__(self, b: CircuitBuilder, curve: Curve = P256_CURVE):
        self.b = b
        self.curve = curve
        self.fp = CrtChip(b, curve.p)
        self.fn = CrtChip(b, curve.n)
        self.ecc = EccChip(b, self.fp, curve)

    # --- scalar digit machinery -----------------------------------------
    def digit_decompose(self, u: CrtInt) -> list[Cell]:
        """64 x 4-bit digit cells of u' = (u - C0) mod n, constrained so
        sum_w (d_w) 16^w + C0 === u (mod n)."""
        b = self.b
        n_mod = self.curve.n
        u_adj = (u.value - C0) % n_mod
        digits = [(u_adj >> (WINDOW * w)) & 15 for w in range(NUM_WINDOWS)]
        cells = b.load_witnesses(digits)
        # digits are fully bit-constrained inside digit_indicators (every
        # window builds indicators), so no separate range check is needed
        # recompose into 88/88/80-bit limbs
        limbs = []
        for j in range(3):
            grp = cells[j * DIGITS_PER_LIMB : (j + 1) * DIGITS_PER_LIMB]
            coefs = [1 << (WINDOW * i) for i in range(len(grp))]
            limbs.append(b.inner_product(grp, coefs))
        d_crt = CrtInt(limbs, u_adj)
        c0 = self.fn.constant(C0)
        self.fn.linear_constrain([(1, d_crt), (1, c0), (-1, u)], self.fn.zero())
        return cells

    def var_base_mul(self, q: EcPoint, u: CrtInt) -> EcPoint:
        """u * q via 4-bit windows over an in-circuit (i+1)*q table."""
        ecc = self.ecc
        digits = self.digit_decompose(u)
        table = [q]
        dbl = ecc.double(q)
        table.append(dbl)
        for i in range(2, 16):
            table.append(ecc.add_unequal(table[-1], q))
        inds = ecc.digit_indicators(digits[NUM_WINDOWS - 1], WINDOW)
        acc = ecc.mux(inds, table)
        for w in range(NUM_WINDOWS - 2, -1, -1):
            for _ in range(WINDOW):
                acc = ecc.double(acc)
            inds = ecc.digit_indicators(digits[w], WINDOW)
            t = ecc.mux(inds, table)
            acc = ecc.add_unequal(acc, t)
        return acc

    def fixed_base_mul(self, u: CrtInt) -> EcPoint:
        """u * G via constant per-window tables (no in-circuit doublings)."""
        ecc = self.ecc
        digits = self.digit_decompose(u)
        tables = _fixed_base_tables(self.curve)
        const_tables = [
            [ecc.constant_point(pt) for pt in tables[w]]
            for w in range(NUM_WINDOWS)
        ]
        inds = ecc.digit_indicators(digits[0], WINDOW)
        acc = ecc.mux(inds, const_tables[0])
        for w in range(1, NUM_WINDOWS):
            inds = ecc.digit_indicators(digits[w], WINDOW)
            t = ecc.mux(inds, const_tables[w])
            acc = ecc.add_unequal(acc, t)
        return acc

    # --- the verify statement -------------------------------------------
    def verify(self, r_int: int, s_int: int, m_int: int,
               pk: tuple[int, int]) -> Cell:
        """Constrain the full ECDSA verification statement (private
        witnesses, no public inputs — matching the reference circuit's
        interface, ecdsa_p256.rs:65-72/245). Returns a constrained cell of
        the recovered point's x-coordinate (the gadget's "result cell",
        cf. the reference's printed result — ecdsa_p256.rs:199)."""
        m = self.fn.load(m_int)
        self.fn.enforce_canonical(m)
        self.last_m = m  # exposed for public-input binding (CrtInt)
        return self.verify_with_m(r_int, s_int, m, pk)

    def verify_with_m(self, r_int: int, s_int: int, m,
                      pk: tuple[int, int]) -> Cell:
        """ECDSA verify with the message already in-circuit (any proper
        CrtInt representative < 2^256; reduction happens in u1 = m/s).
        Used by the ES256 circuit, whose m comes out of in-circuit SHA-256."""
        fn, fp, ecc = self.fn, self.fp, self.ecc
        n_mod = self.curve.n
        m_int = m.value

        r = fn.load(r_int)
        s = fn.load(s_int)
        fn.enforce_canonical(r)
        fn.enforce_canonical(s)
        fn.assert_nonzero_mod(r)
        w_inv = fn.load(pow(s_int, -1, n_mod))
        fn.mul_constrain(s, w_inv, fn.one())  # also proves s != 0
        u1 = fn.mul(m, w_inv)
        u2 = fn.mul(r, w_inv)

        pk_pt = ecc.load_point(pk, check=True)
        p1 = self.fixed_base_mul(u1)
        p2 = self.var_base_mul(pk_pt, u2)
        r_pt = ecc.add_unequal(p1, p2, strict=True)

        # x(R') === r (mod n): x canonical (< p), then x = r + bit * n
        fp.enforce_canonical(r_pt.x)
        x_val = r_pt.x.value % self.curve.p
        bit_val = 1 if x_val >= n_mod else 0
        assert x_val - bit_val * n_mod == r_int % n_mod, "ECDSA witness invalid"
        [bit] = self.b.load_witnesses([bit_val])
        self.b.assert_bit(bit)
        self._integer_combo_zero(r_pt.x, r, bit)
        return r_pt.x.limbs[0]

    def _integer_combo_zero(self, x: CrtInt, r: CrtInt, bit: Cell) -> None:
        """Exact integer identity x - r - bit*n = 0 (limbwise carries)."""
        b = self.b
        n_limbs = limbs_of(self.curve.n)
        s_cells = []
        for k in range(3):
            bn = b.mul_const(bit, n_limbs[k])
            s = b.sub(x.limbs[k], r.limbs[k])
            s = b.sub(s, bn)
            s_cells.append(s)
        self.fp._carry_chain(s_cells)
