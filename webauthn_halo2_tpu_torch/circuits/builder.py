"""Vertical flex-gate circuit builder + range chip (halo2-base equivalent).

Re-creates the gadget substrate the reference consumes from `halo2-base`
(SURVEY §2.2): a single custom gate per advice column,

    q[i] * (A[i] + A[i+1]*A[i+2] - A[i+3]) = 0,

with copy constraints carrying dataflow, a constants fixed column, and
dedicated lookup-advice columns whose every row is range-checked against a
fixed table of [0, 2^lookup_bits). The same parameter vocabulary as the
reference config (num_advice / num_lookup_advice / num_fixed / lookup_bits
— ecdsa_circuit.config) is preserved.

Witness values are computed eagerly (Python ints) while gadgets run; the
layout (selectors, copies, lookups) is witness-independent, so keygen can
run the builder with any witness.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

from ..fields.constants import BN254_FR
from ..plonk import cs as CS

R = BN254_FR


class Cell(NamedTuple):
    """A witnessed advice cell (NamedTuple: ~2x cheaper to build than a
    dataclass — the ECDSA circuit creates ~1.3M of these per synthesis)."""

    col: int  # advice column index
    row: int
    value: int

    def __int__(self):
        return self.value


class CircuitBuilder:
    def __init__(self, num_advice: int = 4, num_lookup_advice: int = 1,
                 lookup_bits: int = 16, check: bool = True,
                 layout: bool = True, balance: bool = False):
        # balance=True places each region on the currently-shortest gate
        # column instead of round-robin: region sizes are uneven, and at
        # high column counts (low k) the round-robin skew can push one
        # column past the usable rows no matter how many columns exist
        self.balance = balance
        self.num_advice = num_advice
        self.num_lookup_advice = num_lookup_advice
        self.lookup_bits = lookup_bits
        self.check = check  # witness sanity asserts (off on the hot path)
        # layout=False: values-only synthesis for per-proof witness
        # regeneration — selectors/copies/constants are witness-independent
        # (cached from keygen's run), so the hot path skips all layout
        # bookkeeping (~2x faster; profile: copies+selector appends dominate)
        self.layout = layout
        self.columns: list[list[int]] = [[] for _ in range(num_advice)]
        # balance: (rows, column) after each placement, a min-heap whose top
        # live entry is the first of the shortest columns
        self._fill = [(0, c) for c in range(num_advice)]
        self.selectors: list[list[int]] = [[] for _ in range(num_advice)]
        self._col_rr = 0
        self.copies: list = []  # ((kind, col, row), (kind, col, row))
        self.const_rows: dict[int, int] = {}  # value -> row in constants col
        self.const_col: list[int] = []
        self.lookup_values: list[tuple[int, int, int]] = []  # (col,row,value)
        # paired (key, value) lookup tables, e.g. 8-bit XOR/AND for SHA-256:
        # name -> dict(fn=..., pairs=[(key_cell, val_cell), ...])
        self.pair_tables: dict = {}
        # cells exposed as public inputs (instance column 0, row = order):
        # the standard halo2 mechanism — a copy constraint ties the advice
        # cell to the instance cell through the permutation argument
        self.public_cells: list = []

    # --- low-level assignment -------------------------------------------
    def assign_region(self, values: list[int], gate_offsets: list[int],
                      column: int | None = None) -> list[Cell]:
        """Append `values` to one gate column; enable the vertical gate at
        the given offsets (each asserts v[o] + v[o+1]*v[o+2] == v[o+3])."""
        if column is not None:
            col = column
        elif self.balance:
            col = self._shortest()
        else:
            col = self._col_rr
        self._col_rr = (col + 1) % self.num_advice
        base = len(self.columns[col])
        vals = [v % R for v in values]
        self.columns[col].extend(vals)
        if self.balance:
            heapq.heappush(self._fill, (len(self.columns[col]), col))
        if self.layout:
            sel = self.selectors[col]
            sel.extend([0] * len(vals))
            if self.check:
                for o in gate_offsets:
                    assert o + 3 < len(vals)
                    assert (vals[o] + vals[o + 1] * vals[o + 2] - vals[o + 3]) % R == 0, (
                        "unsatisfied vertical gate in assign_region"
                    )
                    sel[base + o] = 1
            else:
                for o in gate_offsets:
                    sel[base + o] = 1
        return [Cell(col, base + i, v) for i, v in enumerate(vals)]

    def _shortest(self) -> int:
        """The column `min(range(num_advice), key=len(columns[c]))` gives,
        in logarithmic time: entries a later placement outdated are dropped
        as they reach the top."""
        while True:
            rows, col = self._fill[0]
            if rows == len(self.columns[col]):
                return col
            heapq.heappop(self._fill)

    def expose_public(self, cell: Cell) -> int:
        """Bind `cell` to public-input row len(public_cells) (instance
        column 0). Returns the instance row index. The proof then only
        verifies against instances[0][row] == cell value (the
        userOpHash-binding plumbing — P256Account.sol:77 TODO)."""
        self.public_cells.append(cell)
        return len(self.public_cells) - 1

    def copy(self, a: Cell, b: Cell) -> None:
        if not self.layout:
            return
        if self.check:
            assert a.value == b.value, "copy constraint between unequal values"
        self.copies.append(
            ((CS.ADVICE, a.col, a.row), (CS.ADVICE, b.col, b.row))
        )

    def constant(self, v: int) -> int:
        """Row of `v` in the constants fixed column (deduplicated)."""
        v %= R
        if v not in self.const_rows:
            self.const_rows[v] = len(self.const_col)
            self.const_col.append(v)
        return self.const_rows[v]

    def constrain_constant(self, cell: Cell, v: int) -> None:
        if not self.layout:
            return
        row = self.constant(v)
        self.copies.append(
            ((CS.ADVICE, cell.col, cell.row), (CS.FIXED_CONST, 0, row))
        )

    # --- arithmetic gadgets ---------------------------------------------
    def load_constant(self, v: int) -> Cell:
        [c] = self.load_witnesses([v])
        self.constrain_constant(c, v)
        return c

    def load_witnesses(self, vs: list[int]) -> list[Cell]:
        """Free cells (no gate); constrained only by later uses."""
        cells = self.assign_region([v % R for v in vs], [])
        return cells

    def add(self, a: Cell, b: Cell) -> Cell:
        out = (a.value + b.value) % R
        cs_ = self.assign_region([a.value, b.value, 1, out], [0])
        self.copy(cs_[0], a)
        self.copy(cs_[1], b)
        self.constrain_constant(cs_[2], 1)
        return cs_[3]

    def sub(self, a: Cell, b: Cell) -> Cell:
        out = (a.value - b.value) % R
        cs_ = self.assign_region([out, b.value, 1, a.value], [0])
        self.copy(cs_[1], b)
        self.constrain_constant(cs_[2], 1)
        self.copy(cs_[3], a)
        return cs_[0]

    def mul(self, a: Cell, b: Cell) -> Cell:
        out = a.value * b.value % R
        cs_ = self.assign_region([0, a.value, b.value, out], [0])
        self.constrain_constant(cs_[0], 0)
        self.copy(cs_[1], a)
        self.copy(cs_[2], b)
        return cs_[3]

    def mul_add(self, a: Cell, b: Cell, c: Cell) -> Cell:
        """c + a*b"""
        out = (c.value + a.value * b.value) % R
        cs_ = self.assign_region([c.value, a.value, b.value, out], [0])
        self.copy(cs_[0], c)
        self.copy(cs_[1], a)
        self.copy(cs_[2], b)
        return cs_[3]

    def mul_const(self, a: Cell, k: int) -> Cell:
        k %= R
        out = a.value * k % R
        cs_ = self.assign_region([0, a.value, k, out], [0])
        self.constrain_constant(cs_[0], 0)
        self.copy(cs_[1], a)
        self.constrain_constant(cs_[2], k)
        return cs_[3]

    def add_const(self, a: Cell, k: int) -> Cell:
        k %= R
        out = (a.value + k) % R
        cs_ = self.assign_region([a.value, k, 1, out], [0])
        self.copy(cs_[0], a)
        self.constrain_constant(cs_[1], k)
        self.constrain_constant(cs_[2], 1)
        return cs_[3]

    def inner_product(self, avs: list[Cell], bvs: list) -> Cell:
        """sum a_i * b_i; bvs entries are Cells or int constants.

        Chained windows share boundary cells: 3 extra cells per term.
        """
        assert len(avs) == len(bvs) and avs
        acc = 0
        vals = [0]
        gates = []
        copy_plan = []  # (offset, cell/const)
        copy_plan.append((0, 0))  # constant zero start
        for i, (a, b) in enumerate(zip(avs, bvs)):
            bv = b.value if isinstance(b, Cell) else b % R
            acc = (acc + a.value * bv) % R
            o = 3 * i
            gates.append(o)
            vals.extend([a.value, bv, acc])
            copy_plan.append((o + 1, a))
            copy_plan.append((o + 2, b))
        cells = self.assign_region(vals, gates)
        for off, src in copy_plan:
            if isinstance(src, Cell):
                self.copy(cells[off], src)
            else:
                self.constrain_constant(cells[off], src)
        return cells[-1]

    def select(self, cond: Cell, a: Cell, b: Cell) -> Cell:
        """cond ? a : b  (cond must be boolean-constrained by the caller)."""
        d = self.sub(a, b)
        return self.mul_add(cond, d, b)

    def assert_bit(self, c: Cell) -> None:
        """c * (c - 1) == 0  via  0 + c*cm1 = 0 and cm1 = c - 1."""
        cm1 = self.add_const(c, R - 1)
        prod = self.mul(c, cm1)
        self.constrain_constant(prod, 0)

    def assert_equal(self, a: Cell, b: Cell) -> None:
        self.copy(a, b)

    def assert_zero(self, a: Cell) -> None:
        self.constrain_constant(a, 0)

    # --- range chip ------------------------------------------------------
    def raw_lookup(self, cell: Cell) -> None:
        """Copy `cell` into a lookup-advice slot (=> value in [0, 2^bits))."""
        assert 0 <= cell.value < (1 << self.lookup_bits), (
            f"lookup witness {cell.value} out of range"
        )
        slot_col = len(self.lookup_values) % self.num_lookup_advice
        self.lookup_values.append((cell.col, cell.row, cell.value))

    def add_pair_table(self, name: str, fn) -> None:
        """Register a 16-bit-keyed (key, value) lookup table: row i has
        key = i, value = fn(i & 255, i >> 8). Used for bytewise XOR/AND."""
        if name not in self.pair_tables:
            self.pair_tables[name] = dict(fn=fn, pairs=[])

    def pair_lookup(self, name: str, key: Cell, val: Cell) -> None:
        """Constrain (key, val) to appear in the named pair table."""
        tab = self.pair_tables[name]
        if self.check:
            assert tab["fn"](key.value & 255, key.value >> 8) == val.value, (
                f"pair lookup {name} witness broken"
            )
        tab["pairs"].append((key, val))

    def range_check(self, cell: Cell, bits: int) -> None:
        """Constrain 0 <= cell < 2^bits via lookup-limb decomposition."""
        lb = self.lookup_bits
        assert 0 <= cell.value < (1 << bits), (
            f"range_check witness {cell.value} needs {bits} bits"
        )
        if bits <= lb:
            if bits == lb:
                self.raw_lookup(cell)
                return
            # check cell * 2^(lb-bits) also fits in lb bits
            shifted = self.mul_const(cell, 1 << (lb - bits))
            self.raw_lookup(cell)
            self.raw_lookup(shifted)
            return
        nlimbs = -(-bits // lb)
        v = cell.value
        limbs = [(v >> (lb * i)) & ((1 << lb) - 1) for i in range(nlimbs)]
        limb_cells = self.load_witnesses(limbs)
        recomposed = self.inner_product(
            limb_cells, [pow(2, lb * i, R) for i in range(nlimbs)]
        )
        self.assert_equal(recomposed, cell)
        for i, lc in enumerate(limb_cells):
            rem = bits - lb * i
            self.range_check(lc, min(lb, rem))

    def assert_less_than_const(self, cell: Cell, bound: int, bits: int) -> None:
        """0 <= cell < bound, where bound < 2^bits (needs cell < 2^bits too)."""
        self.range_check(cell, bits)
        shifted = self.add_const(cell, (1 << bits) - bound)
        self.range_check(shifted, bits)

    def is_zero(self, a: Cell) -> Cell:
        """Returns bit b = (a == 0): witness inv; b = 1 - a*inv; a*b = 0."""
        inv = pow(a.value, -1, R) if a.value else 0
        [ic] = self.load_witnesses([inv])
        prod = self.mul(a, ic)  # a*inv
        one = self.load_constant(1)
        b = self.sub(one, prod)
        z = self.mul(a, b)
        self.constrain_constant(z, 0)
        return b

    def assert_nonzero(self, a: Cell) -> None:
        inv = pow(a.value, -1, R)
        [ic] = self.load_witnesses([inv])
        prod = self.mul(a, ic)
        self.constrain_constant(prod, 1)

    # --- finalization -----------------------------------------------------
    def finalize_values(self) -> list:
        """Advice column VALUES only (layout=False fast path): same column
        order and row placement as finalize(), no cs/fixed/copies."""
        nl = self.num_lookup_advice
        lookup_cols: list[list[int]] = [[] for _ in range(nl)]
        for t_i, (_scol, _srow, val) in enumerate(self.lookup_values):
            lookup_cols[t_i % nl].append(val)
        advice = [list(c) for c in self.columns] + lookup_cols
        for tab in self.pair_tables.values():
            advice.append([kc.value for kc, _ in tab["pairs"]])
            advice.append([vc.value for _, vc in tab["pairs"]])
        return advice

    def finalize(self, k: int):
        """Produce (cs, fixed_cols, advice_cols, copies) for keygen/prover.

        Column order: fixed = [sel_0..sel_{na-1}, constants, table];
        advice = [gate_0..gate_{na-1}, lookup_0..lookup_{nl-1}].
        """
        from ..plonk.cs import ConstraintSystem

        n = 1 << k
        na, nl = self.num_advice, self.num_lookup_advice
        npair = len(self.pair_tables)
        # fixed: na selectors + constants + range table + 2 per pair table
        # advice: na gates + nl range-lookup + 2 per pair table
        cs = ConstraintSystem(
            num_fixed=na + 2 + 2 * npair,
            num_advice=na + nl + 2 * npair,
            num_instance=1 if self.public_cells else 0,
        )
        for i in range(na):
            q = CS.fixed(i)
            a0, a1, a2, a3 = (CS.advice(i, r) for r in range(4))
            cs.gate(f"vgate{i}", q * (a0 + a1 * a2 - a3))
        for j in range(nl):
            cs.lookup(f"range{j}", [CS.advice(na + j)], [CS.fixed(na + 1)])
        for p_i, name in enumerate(self.pair_tables):
            ak, av = na + nl + 2 * p_i, na + nl + 2 * p_i + 1
            fk, fv = na + 2 + 2 * p_i, na + 2 + 2 * p_i + 1
            cs.lookup(f"pair_{name}", [CS.advice(ak), CS.advice(av)],
                      [CS.fixed(fk), CS.fixed(fv)])
        for i in range(cs.num_advice):
            cs.enable_permutation(CS.ADVICE, i)
        cs.enable_permutation(CS.FIXED, na)  # constants column
        if self.public_cells:
            cs.enable_permutation(CS.INSTANCE, 0)

        usable = cs.usable_rows(n)
        table = [i for i in range(1 << self.lookup_bits)]
        assert len(table) <= usable, (
            f"lookup table (2^{self.lookup_bits}) does not fit at k={k}"
        )
        table += [0] * (n - len(table))

        # distribute lookup cells over the lookup-advice columns
        lookup_cols: list[list[int]] = [[] for _ in range(nl)]
        lookup_copies = []
        per = -(-len(self.lookup_values) // nl) if self.lookup_values else 0
        assert per <= usable, "lookup-advice column overflow"
        for t_i, (scol, srow, val) in enumerate(self.lookup_values):
            j = t_i % nl
            lookup_copies.append(
                ((CS.ADVICE, scol, srow),
                 (CS.ADVICE, na + j, len(lookup_cols[j])))
            )
            lookup_cols[j].append(val)

        for col in self.columns:
            assert len(col) <= usable, (
                f"gate column overflow: {len(col)} rows > usable {usable}"
            )

        fixed_cols = [
            sel + [0] * (n - len(sel)) for sel in self.selectors
        ]
        fixed_cols.append(self.const_col + [0] * (n - len(self.const_col)))
        fixed_cols.append(table)

        advice_cols = [list(c) for c in self.columns] + [
            list(c) for c in lookup_cols
        ]

        pair_copies = []
        for p_i, (name, tab) in enumerate(self.pair_tables.items()):
            keys = [i for i in range(1 << 16)]
            vals = [tab["fn"](i & 255, i >> 8) for i in range(1 << 16)]
            assert len(keys) <= usable, "pair table does not fit"
            fixed_cols.append(keys + [0] * (n - len(keys)))
            fixed_cols.append(vals + [0] * (n - len(vals)))
            ak, av = na + nl + 2 * p_i, na + nl + 2 * p_i + 1
            kcol, vcol = [], []
            assert len(tab["pairs"]) <= usable, f"pair lookup {name} overflow"
            for row, (kc, vc) in enumerate(tab["pairs"]):
                pair_copies.append(
                    ((CS.ADVICE, kc.col, kc.row), (CS.ADVICE, ak, row))
                )
                pair_copies.append(
                    ((CS.ADVICE, vc.col, vc.row), (CS.ADVICE, av, row))
                )
                kcol.append(kc.value)
                vcol.append(vc.value)
            advice_cols.append(kcol)
            advice_cols.append(vcol)

        # rewrite FIXED_CONST placeholder to the actual constants column idx
        copies = []
        for a, b in self.copies + lookup_copies + pair_copies:
            copies.append((_fix(a, na), _fix(b, na)))
        for row, cell in enumerate(self.public_cells):
            copies.append(((CS.ADVICE, cell.col, cell.row),
                           (CS.INSTANCE, 0, row)))
        return cs, fixed_cols, advice_cols, copies


# marker for constants-column copies before the index is known
class _FixedConstKind:
    pass


CS.FIXED_CONST = "fixed_const"


def _fix(ref, na):
    kind, col, row = ref
    if kind == CS.FIXED_CONST:
        return (CS.FIXED, na, row)
    return ref
