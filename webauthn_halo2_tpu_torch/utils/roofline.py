"""The H100's ceilings, the work of the port's kernels and of a proof's
phases, and the least time the card could take for it.

The counterpart of the JAX package's utils/roofline.py, in the port's own
units: a field element is eight 32-bit words (32 bytes), and arithmetic is
counted in 32-bit integer multiply-adds (IMAD), the instruction a CIOS
Montgomery multiply is made of. A bound is the larger of two times: the
bytes a function must move (each input read once, each output written
once) over the memory rate, and its operations over their rate. Where the
work depends on the data, the kernel checks count it from their own inputs
and give these helpers the counts.

`proof_work_model(pk, scheme, advice)` counts the least work of each prover phase from the
key's own shapes (its MSMs, transforms, the quotient's gate terms and the
openings), and `report(spans, model)` sets the phases' measured seconds
(prover.LAST_SPANS, under WH2_TRACE) beside it.
"""
from __future__ import annotations

import torch

from ..fields.constants import BN254_FR
from ..fields.limbs import ints_to_words
from ..ops.msm import SCALAR_BITS, _default_c, scalar_digits
from ..plonk import cs as CS
from ..plonk.prover import query_plan

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes per second,
# and 32-bit integer multiply-adds per second. The integer rate is not in
# the data sheet's table: an SM issues 64 INT32 lanes per clock, half its
# 128 FP32 lanes, so it is half the 67 TFLOP/s float32 rate counted in
# instructions: 67e12 / 2 (FMA = 2 flops) / 2 = 16.75e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
# dense int8 tensor-core operations per second (a multiply-add is two)
INT8_OPS_PER_S = 1979e12
# thread instructions issued per second: 132 SMs, four schedulers of 32
# lanes each, at the 1,980 MHz maximum SM clock
INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9
# one 8-word CIOS Montgomery multiply: 64 a*b and 64 m*p word products,
# each a 32x32 -> 64-bit product (two IMADs: low and high half)
IMAD_PER_MONTMUL = 256
# a Montgomery square: 28 cross products once, doubled, 8 squares, then the
# 64 reduction products: 100 word products
IMAD_PER_MONTSQR = 200
# a mixed add (Z2 = 1): 8 multiplies and 3 squares; a Jacobian add: 12 and 4
IMAD_PER_MADD = 8 * IMAD_PER_MONTMUL + 3 * IMAD_PER_MONTSQR
IMAD_PER_JADD = 12 * IMAD_PER_MONTMUL + 4 * IMAD_PER_MONTSQR
ELEM_BYTES = 32

# the prover's spans (plonk/prover.py), in proof order
PHASES = ("advice encode+commit", "lookup permute+commit",
          "grand products + z commits", "quotient (conversions + h)",
          "evaluations", "multiopen")


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def bound_terms(row: dict) -> dict:
    """ms of each term of a row's bound: its bytes over the memory rate, its
    operations over their rate (`rate`, default IMAD_PER_S), and, where the
    row counts them, its 32-bit operations around the tensor-core products
    (`glue_ops`) over the SMs' issue rate."""
    terms = dict(bytes=row["bytes"] / HBM_BYTES_PER_S * 1e3,
                 operations=row["ops"] / row.get("rate", IMAD_PER_S) * 1e3)
    if "glue_ops" in row:
        terms["glue"] = row["glue_ops"] / INSTRUCTIONS_PER_S * 1e3
    return terms


def bound_ms(row: dict) -> tuple:
    """(the least ms of a row's work, "bytes" or "operations")."""
    terms = bound_terms(row)
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations"


# ---------------------------------------------------------------------------
# the work of one kernel launch
# ---------------------------------------------------------------------------

def montmul_work(n: int, a_elems: int | None = None, b_elems: int | None = None) -> dict:
    """n Montgomery multiplies of two operands of a_elems and b_elems
    elements (n each unless given: a broadcast operand is 1)."""
    a = n if a_elems is None else a_elems
    b = n if b_elems is None else b_elems
    return dict(bytes=ELEM_BYTES * (a + b + n), ops=IMAD_PER_MONTMUL * n)


def _stage_mults(B: int, n: int, s: int) -> int:
    # a butterfly of stage s whose twiddle is w^0 = 1 (j = 0, one in 2^s of
    # them) needs no multiply: the least work counts the others only
    return B * (n // 2) - B * (n >> (s + 1))


def stage_a_work(B: int, n: int, log_t: int) -> dict:
    """NTT stage A: stages 0 .. log_t - 1 of B columns of n, in one pass."""
    mults = sum(_stage_mults(B, n, s) for s in range(log_t))
    return dict(bytes=2 * ELEM_BYTES * B * n + ELEM_BYTES * ((1 << log_t) - 1),
                ops=IMAD_PER_MONTMUL * mults)


def stage_b_work(B: int, n: int, s: int) -> dict:
    """NTT stage B: stage s of B columns of n."""
    return dict(bytes=2 * ELEM_BYTES * B * n + ELEM_BYTES * (1 << s),
                ops=IMAD_PER_MONTMUL * _stage_mults(B, n, s))


def ntt_work(B: int, k: int) -> dict:
    """A whole transform of B columns of 2^k, read and written once, with
    the n^-1 scale of an inverse left out (a coset shift or scale is a
    montmul_work of its own)."""
    n = 1 << k
    mults = sum(_stage_mults(B, n, s) for s in range(k))
    return dict(bytes=2 * ELEM_BYTES * B * n + ELEM_BYTES * (n - 1),
                ops=IMAD_PER_MONTMUL * mults)


def ec_add_work(nrows: int, lanes: int, adds: int) -> dict:
    """The fused EC add over (8, nrows, lanes) Jacobian operands, `adds` of
    them with two finite points (an add with an infinity is a select)."""
    return dict(bytes=9 * ELEM_BYTES * nrows * lanes, ops=IMAD_PER_JADD * adds)


def msm_work(n: int, batch: int, c: int | None = None,
             madds: int | None = None) -> dict:
    """`batch` MSMs over one set of n affine points, window c: every point
    read once (x, y), every scalar once; a mixed add a nonzero digit into
    its bucket (`madds`, by default every digit: random scalars), then per
    window the running sums over 2^c buckets (two Jacobian adds a bucket)."""
    c = c or _default_c(n)
    windows = -(-SCALAR_BITS // c)
    if madds is None:
        madds = windows * batch * n
    jadds = windows * batch * 2 * (1 << c)
    return dict(bytes=2 * ELEM_BYTES * n + ELEM_BYTES * batch * n,
                ops=IMAD_PER_MADD * madds + IMAD_PER_JADD * jadds)


# ---------------------------------------------------------------------------
# the work of one proof, phase by phase
# ---------------------------------------------------------------------------

def _expr_mults(e) -> int:
    """Montgomery multiplies of one evaluation of a gate expression
    (CS.eval_device: a product or a scaled term is one)."""
    if isinstance(e, CS.Prod):
        return 1 + _expr_mults(e.a) + _expr_mults(e.b)
    if isinstance(e, CS.Scaled):
        return 1 + _expr_mults(e.a)
    if isinstance(e, CS.Sum):
        return _expr_mults(e.a) + _expr_mults(e.b)
    return 0


def quotient_terms(cs: CS.ConstraintSystem) -> tuple[int, int]:
    """(multiplies, squares) of the quotient's gate system a row of the
    extended domain, as prover._quotient_body evaluates it: the gates, the
    permutation and lookup arguments, the fold by y and the division by
    Z_H."""
    mults = sum(_expr_mults(g) for _, g in cs.gates)
    sqrs = 0
    nconstraints = len(cs.gates)
    nz = cs.num_perm_chunks()
    if cs.perm_columns:
        # l0 (1 - z0), l_last (z^2 - z), l0 (z_i - z_{i-1}(w^u X)), and per
        # column delta^j X, beta sigma, beta id and the two running products,
        # then active (left - right) a chunk
        mults += 2 + (nz - 1) + 5 * len(cs.perm_columns) + nz
        sqrs += 1
        nconstraints += 2 + (nz - 1) + nz
    for _ in cs.lookups:
        mults += 10
        sqrs += 1
        nconstraints += 5
    return mults + (nconstraints - 1) + 1, sqrs


def _add(*rows: dict, upper: bool = False) -> dict:
    work = dict(bytes=sum(r["bytes"] for r in rows), ops=sum(r["ops"] for r in rows))
    if upper:
        work["upper"] = True
    return work


def _scan_work(B: int, n: int) -> dict:
    # a grand product's z: 1/den by batch inversion (three multiplies a
    # row), the ratio, the prefix product and the carry
    return montmul_work(6 * B * n)


def _opening_work(cs: CS.ConstraintSystem, k: int, scheme: str) -> dict:
    """The multiopen phase: per SHPLONK point set (or GWC rotation group)
    the folded polynomial, its transforms, the division by the vanishing
    polynomial of the set's points, and the commitments."""
    n = 1 << k
    plan = query_plan(cs, n) + [(("h",), 0)]
    rots_of: dict = {}
    for label, rot in plan:
        rots_of.setdefault(label, set()).add(rot)
    work = []
    if scheme == "gwc":
        groups: dict = {}
        for label, rot in plan:
            groups.setdefault(rot, []).append(label)
        for members in groups.values():
            work += [montmul_work((len(members) - 1) * n), montmul_work(2 * n),
                     ntt_work(1, k), ntt_work(1, k), montmul_work(4 * n)]
        work.append(msm_work(n, len(groups)))
        return _add(*work)
    sets: dict = {}
    for label, rots in rots_of.items():
        sets.setdefault(tuple(sorted(rots)), []).append(label)
    for rkey, members in sets.items():
        # F folded by v, F and r to the coset (shift + transform each), the
        # vanishing product over the set's points, num / zs
        work += [montmul_work((len(members) - 1) * n), montmul_work(2 * n),
                 ntt_work(2, k), montmul_work(len(rkey) * n), montmul_work(4 * n)]
    # h back to coefficients; W: L folded, to the coset, / (X - u), back
    work += [montmul_work((len(sets) - 1) * n), ntt_work(1, k), montmul_work(n),
             montmul_work((len(sets) + 1) * n), ntt_work(2, k), montmul_work(7 * n)]
    work.append(msm_work(n, 2))
    return _add(*work)


def nonzero_digits(columns: list, n: int, usable: int) -> int:
    """The nonzero c-bit digits (c = the MSM's window at n) of the advice
    commitment's scalars: each column's values, zero up to `usable` rows,
    then n - usable random blinding values, counted as every digit nonzero."""
    c = _default_c(n)
    windows = -(-SCALAR_BITS // c)
    count = 0
    for col in columns:
        if col:
            words = torch.as_tensor(ints_to_words([v % BN254_FR for v in col]))
            count += int((scalar_digits(words, c) != 0).sum())
    return count + len(columns) * (n - usable) * windows


def proof_work_model(pk, scheme: str = "shplonk", advice: list | None = None) -> dict:
    """The least work of each phase of one proof with `pk`, {span name:
    {"bytes", "ops"}}, from the key's own shapes: the MSM batches, the
    transforms, the quotient's gate terms on the extended domain, the
    evaluations and the openings of `scheme`. Given the proof's `advice`
    columns, the advice commitment counts their nonzero digits (a host
    pass over the columns, most of a second at k=17: keep it out of a
    timed proof). Without them, and for the lookups' permuted columns
    always, every digit of a committed column counts: an upper count for
    sparse columns, and such a phase is marked "upper"."""
    cs = pk.vk.cs
    domain = pk.vk.domain
    k, ek = domain.k, domain.extended_k
    n, ext_n = domain.n, domain.ext_n
    na, ni = cs.num_advice, cs.num_instance
    nz, nlk = cs.num_perm_chunks(), len(cs.lookups)
    nf, nsig = cs.num_fixed, len(cs.perm_columns)
    m_stack = na + ni + nz + 5 * nlk + 1
    pieces = cs.degree() - 1
    theta = sum(len(lk.inputs) - 1 + len(lk.tables) - 1 for lk in cs.lookups)
    lk_mults = sum(_expr_mults(e) for lk in cs.lookups for e in lk.inputs + lk.tables)
    q_mults, q_sqrs = quotient_terms(cs)
    plan = query_plan(cs, n)
    nrots = len({rot for _, rot in plan} | {0})
    return {
        "advice encode+commit": _add(montmul_work((na + ni) * n), msm_work(
            n, na, madds=None if advice is None
            else nonzero_digits(advice, n, cs.usable_rows(n))), upper=advice is None),
        "lookup permute+commit": _add(
            montmul_work((lk_mults + theta) * n), montmul_work(4 * nlk * n),
            msm_work(n, 2 * nlk), upper=nlk > 0),
        "grand products + z commits": _add(
            montmul_work(5 * nsig * n), _scan_work(nz + nlk, n),
            montmul_work(2 * nlk * n), montmul_work((nz + nlk + 1) * n),
            msm_work(n, nz + nlk + 1)),
        "quotient (conversions + h)": _add(
            ntt_work(m_stack, k), montmul_work(m_stack * n),
            montmul_work(m_stack * ext_n), ntt_work(m_stack, ek),
            dict(bytes=ELEM_BYTES * ext_n * (m_stack + nf + nsig + 6),
                 ops=(IMAD_PER_MONTMUL * q_mults + IMAD_PER_MONTSQR * q_sqrs) * ext_n),
            ntt_work(1, ek), montmul_work(2 * ext_n), msm_work(n, pieces)),
        # a power table a rotation, every query's terms, h folded and evaluated
        "evaluations": montmul_work((nrots + len(plan) + pieces) * n),
        "multiopen": _opening_work(cs, k, scheme),
    }


def report(spans: dict, model: dict) -> list[dict]:
    """One row a prover phase (PHASES, in order) and a total: its seconds
    (None where `spans` lacks it), its IMADs and bytes, the least seconds
    the card could take for them (each phase bounded by the larger of its
    two terms) and the fraction of that bound the phase reached; "upper"
    where the phase's work is an upper count (proof_work_model)."""
    rows = []
    for name in PHASES:
        w = model[name]
        bound_s = bound_ms(w)[0] / 1e3
        t = spans.get(name)
        rows.append(dict(phase=name, s=t, imad=w["ops"], bytes=w["bytes"],
                         bound_s=bound_s, fraction=bound_s / t if t else None,
                         upper=w.get("upper", False)))
    total_t = sum(r["s"] or 0.0 for r in rows)
    total_b = sum(r["bound_s"] for r in rows)
    rows.append(dict(phase="total", s=total_t, imad=sum(r["imad"] for r in rows),
                     bytes=sum(r["bytes"] for r in rows), bound_s=total_b,
                     fraction=total_b / total_t if total_t else None,
                     upper=any(r["upper"] for r in rows)))
    return rows


def format_report(rows: list[dict]) -> str:
    """report()'s rows as a table: time, work, bound, fraction reached; a
    "*" marks an upper count of work, so a bound and fraction above the
    least."""
    lines = [f"{'phase':28s} {'time':>9s} {'G IMAD':>9s} {'MB':>9s} "
             f"{'bound':>10s} {'of bound':>9s}"]
    for r in rows:
        t = f"{r['s']:8.3f}s" if r["s"] is not None else f"{'-':>9s}"
        frac = f"{r['fraction']:8.1%}" if r["fraction"] is not None else f"{'-':>9s}"
        mark = "*" if r["upper"] else ""
        lines.append(f"{r['phase']:28s} {t} {r['imad'] / 1e9:9.2f} "
                     f"{r['bytes'] / 1e6:9.1f} {r['bound_s'] * 1e3:8.3f}ms {frac}{mark}")
    if any(r["upper"] for r in rows):
        lines.append("* upper count: every digit of a committed column counted as nonzero")
    return "\n".join(lines)
