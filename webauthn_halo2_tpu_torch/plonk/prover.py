"""The PLONKish prover: create_proof (KZG; SHPLONK or GWC; Blake2b or Keccak).

The port of the JAX package's plonk/prover.py. Protocol phases follow the
PSE halo2 structure: advice commits -> theta -> lookup permuted commits ->
beta/gamma -> permutation and lookup grand products -> vanishing random
poly -> y -> quotient pieces -> x -> evaluations -> SHPLONK multiopen
(v/y challenges, H commitment, u challenge, final witness W), or GWC
(challenge v, one witness commitment per distinct rotation).

`rng(nbytes) -> bytes` is called in exactly the JAX package's order
(advice blinding, lookup blinding, random poly, grand-product tails), so
the same `rng` gives the same proof bytes.
"""
from __future__ import annotations

import os
import sys
import threading
import time as _time

import torch

from ..fields.constants import BN254_FR, BN254_FR_DELTA
from ..fields.limbs import FR_SPEC, W, ints_to_words, words_to_ints
from ..ops import modops as M
from ..device import fence, resolve, tracing
from . import cs as CS
from .domain import Domain
from .fused import FusedPhases, batched_c2e, batched_l2c, to_mont_split, to_mont_stack
from .keygen import commit_coeff, commit_coeff_batch, commit_lagrange_batch
from .transcript import Blake2bWrite

R = BN254_FR
SPEC = FR_SPEC

LAST_SPANS: dict[str, float] = {}  # phase -> seconds, last traced proof


class _Span:
    """Phase span timer, on only under WH2_TRACE (read as each span runs, as
    the JAX package's _Span does): then it fences the proof's stream at both
    ends, so the span holds the device time of its phase, records the
    seconds in LAST_SPANS and prints a `[span]` line to stderr. Untraced it
    does nothing, so two provers on their own streams do not wait for each
    other."""

    fence = staticmethod(fence)

    def __init__(self, name: str, device):
        self.name = name
        self.device = device

    def __enter__(self):
        self.on = tracing()
        if self.on:
            self.fence(self.device)
            self.t0 = _time.time()
        return self

    def __exit__(self, *a):
        if self.on:
            self.fence(self.device)
            dt = _time.time() - self.t0
            LAST_SPANS[self.name] = dt
            print(f"[span] {self.name}: {dt:.3f}s", file=sys.stderr, flush=True)


def _rand_field(rng) -> int:
    return int.from_bytes(rng(32), "little") % R


def _mont_const(v: int, device) -> torch.Tensor:
    return torch.as_tensor(SPEC.encode([v])).to(device)  # (8, 1)


def _pack_std(cols: list, n: int, device) -> torch.Tensor:
    """Host int columns -> (8, B, n) standard words, zero-padded to n."""
    flat: list[int] = []
    for col in cols:
        flat.extend(col)
        flat.extend([0] * (n - len(col)))
    return torch.as_tensor(ints_to_words(flat).reshape(W, len(cols), n)).to(device)


def _stack_or_empty(cols: list, n: int, device) -> torch.Tensor:
    if cols:
        return torch.stack(cols, dim=1)
    return torch.zeros((W, 0, n), dtype=torch.int32, device=device)


_FUSED_LOCK = threading.Lock()


def _fused_for(pk) -> FusedPhases:
    """Phase functions plus the stacked pk tensors (built once per pk, also
    when two threads prove with it at once; proofs only read them)."""
    with _FUSED_LOCK:
        return _fused_for_locked(pk)


def _fused_for_locked(pk) -> FusedPhases:
    fp = getattr(pk, "_fused", None)
    if fp is None:
        fp = FusedPhases(pk)
        n = pk.vk.domain.n
        dev = pk.device
        pk._fixed_lag_stack = _stack_or_empty(pk.fixed_lagrange, n, dev)
        pk._sigma_lag_stack = _stack_or_empty(pk.sigma_lagrange, n, dev)
        pk._fixed_coeff_stack = _stack_or_empty(pk.fixed_coeff, n, dev)
        pk._sigma_coeff_stack = _stack_or_empty(pk.sigma_coeff, n, dev)
        pk._fused = fp
    return fp


def create_proof(
    pk,
    advice_values: list,  # per advice column: list[int] of len <= usable rows
    instances: list,  # per instance column: list[int]
    lookup_fill: list | None = None,  # unused (kept for API compat)
    rng=os.urandom,
    scheme: str = "shplonk",
    transcript=None,
    device=None,
) -> bytes:
    """Prove on `device` (None: the current card), where the pk must lie:
    a pk on another device raises, nothing is moved."""
    if resolve(device) != pk.device:
        raise ValueError(f"pk lies on {pk.device}, create_proof asked for {device}")
    opens = {"shplonk": _shplonk_open, "gwc": _gwc_open}
    if scheme not in opens:
        raise ValueError(f"unknown multiopen scheme {scheme!r}")
    cs = pk.vk.cs
    domain: Domain = pk.vk.domain
    dev = pk.device
    n = domain.n
    usable = cs.usable_rows(n)  # data rows; row `usable` holds z's final value
    omega = domain.omega
    t = transcript if transcript is not None else Blake2bWrite()
    pk.vk.hash_into(t)
    fp = _fused_for(pk)
    na, nz, nlk = fp.na, fp.nz, fp.nlk

    # --- instances (absorbed as scalars) + phase 1: advice commitments ---
    with _Span("advice encode+commit", dev):
        inst_cols = []
        for col in instances:
            vals = [v % R for v in col]
            for v in vals:
                t.common_scalar(v)
            inst_cols.append(vals)
        adv_cols = []
        for col in advice_values:
            vals = [v % R for v in col] + [0] * (usable - len(col))
            vals += [_rand_field(rng) for _ in range(n - usable)]
            adv_cols.append(vals)
        advice_stack, instance_stack = to_mont_split(
            _pack_std(adv_cols + inst_cols, n, dev), na)
        for pt in commit_lagrange_batch(pk.srs, advice_stack):
            t.write_point(pt)

    theta = t.squeeze_challenge()

    # --- phase 2: lookup permuted columns ---
    with _Span("lookup permute+commit", dev):
        lk_mont = torch.zeros((W, 0, n), dtype=torch.int32, device=dev)
        lk_perm_mont = lk_mont
        if nlk:
            lk_mont, lk_std = fp.lookup_compress(
                pk._fixed_lag_stack, advice_stack, instance_stack,
                _mont_const(theta, dev))
            std_np = lk_std.cpu().numpy()  # one host pull for all lookups
            perm_cols_std = []
            for li in range(nlk):
                a_vals = words_to_ints(std_np[:, 2 * li])
                s_vals = words_to_ints(std_np[:, 2 * li + 1])
                a_p, s_p = _permute_lookup_pair(a_vals[:usable], s_vals[:usable])
                a_p += [_rand_field(rng) for _ in range(n - usable)]
                s_p += [_rand_field(rng) for _ in range(n - usable)]
                perm_cols_std.append(a_p)
                perm_cols_std.append(s_p)
            lk_perm_mont = to_mont_stack(_pack_std(perm_cols_std, n, dev))
            for pt in commit_lagrange_batch(pk.srs, lk_perm_mont):
                t.write_point(pt)

    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    beta_t = _mont_const(beta, dev)
    gamma_t = _mont_const(gamma, dev)

    # --- phases 3-5: grand products + random poly + batched commits ---
    with _Span("grand products + z commits", dev):
        rand_vals = [_rand_field(rng) for _ in range(n)]
        tail_len = n - usable - 1
        tails = [[_rand_field(rng) for _ in range(tail_len)]
                 for _ in range(nz + nlk)]
        random_std = _pack_std([rand_vals], n, dev)[:, 0]
        if nz + nlk:
            tails_std = (_pack_std(tails, tail_len, dev) if tail_len else
                         torch.zeros((W, nz + nlk, 0), dtype=torch.int32,
                                     device=dev))
            z_stack, random_lag, commit_stack = fp.grand_products(
                advice_stack, pk._fixed_lag_stack, instance_stack,
                pk._sigma_lag_stack, pk.omega_mont, beta_t, gamma_t,
                lk_mont, lk_perm_mont, tails_std, random_std)
        else:
            z_stack = torch.zeros((W, 0, n), dtype=torch.int32, device=dev)
            commit_stack = to_mont_stack(random_std[:, None])
            random_lag = commit_stack[:, 0]
        for pt in commit_lagrange_batch(pk.srs, commit_stack):
            t.write_point(pt)

    y = t.squeeze_challenge()

    # --- phase 6: quotient ---
    with _Span("quotient (conversions + h)", dev):
        lag_stack = fp.lag_stack(advice_stack, instance_stack, z_stack,
                                 lk_perm_mont, lk_mont, random_lag)
        coeff_stack = batched_l2c(domain.k, lag_stack)
        del lag_stack
        ext_stack = batched_c2e(domain.k, domain.extended_k, coeff_stack)
        h_pieces = fp.quotient(ext_stack, beta_t, gamma_t, _mont_const(y, dev))
        del ext_stack
        for pt in commit_coeff_batch(pk.srs, h_pieces):
            t.write_point(pt)

    x = t.squeeze_challenge()

    # --- phase 7: evaluations (one host pull) ---
    with _Span("evaluations", dev):
        plan = query_plan(cs, n)

        def rot_point(rot: int) -> int:
            if rot >= 0:
                return x * pow(omega, rot, R) % R
            return x * pow(pow(omega, -rot, R), R - 2, R) % R

        rots = sorted({rot for _, rot in plan} | {0})
        pts = torch.as_tensor(SPEC.encode([rot_point(r) for r in rots])).to(dev)
        xn = pow(x, n, R)
        ev_std, h_comb, h_ev_std = fp.evals(
            plan, rots, coeff_stack, pk._fixed_coeff_stack,
            pk._sigma_coeff_stack, h_pieces, pts, _mont_const(xn, dev))
        ev_ints = words_to_ints(ev_std.cpu().numpy())
        h_eval = words_to_ints(h_ev_std.cpu().numpy())[0]
        queries = []  # (label, rot, eval) in multiopen order
        for (label, rot), ev in zip(plan, ev_ints):
            queries.append((label, rot, ev))
            t.write_scalar(ev)
        queries.append((("h",), 0, h_eval))

    # --- phase 8: batch opening ---
    with _Span("multiopen", dev):
        ucoeff = fp.unified_stack(coeff_stack, pk._fixed_coeff_stack,
                                  pk._sigma_coeff_stack, h_comb)
        opens[scheme](pk, fp, t, queries, rot_point, ucoeff)
    fence(dev)  # the proof's own stream: its work is finished when it returns
    return t.finalize()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def query_plan(cs: CS.ConstraintSystem, n: int) -> list:
    """(unified label, rot) of every evaluation a proof writes, in
    multiopen order (the quotient's h is opened after them, at rot 0)."""
    sq = cs.sorted_queries()
    nz = cs.num_perm_chunks()
    nlk = len(cs.lookups)
    u = cs.usable_rows(n)
    plan = []
    for idx, rot in sq[CS.ADVICE]:
        plan.append(((CS.ADVICE, idx), rot))
    for idx, rot in sq[CS.FIXED]:
        plan.append(((CS.FIXED, idx), rot))
    for idx, rot in sq[CS.INSTANCE]:
        plan.append(((CS.INSTANCE, idx), rot))
    plan.append((("random",), 0))
    for j in range(len(cs.perm_columns)):
        plan.append((("sigma", j), 0))
    for i in range(nz):
        plan.append((("perm_z", i), 0))
        plan.append((("perm_z", i), 1))
    for i in range(nz - 1):
        plan.append((("perm_z", i), u))
    for li in range(nlk):
        plan.append((("lookup_z", li), 0))
        plan.append((("lookup_z", li), 1))
        plan.append((("lookup_ap", li), 0))
        plan.append((("lookup_ap", li), -1))
        plan.append((("lookup_sp", li), 0))
    return plan


def _permute_lookup_pair(a_vals: list[int], s_vals: list[int]):
    """halo2 permute_expression_pair: sort input; build table permutation."""
    a_sorted = sorted(a_vals)
    from collections import Counter

    leftover = Counter(s_vals)
    s_perm = [None] * len(a_sorted)
    for i, v in enumerate(a_sorted):
        if i == 0 or v != a_sorted[i - 1]:
            if leftover[v] == 0:
                raise ValueError(f"lookup failure: input value {v} not in table")
            leftover[v] -= 1
            s_perm[i] = v
    fill = iter(sorted(leftover.elements()))
    for i in range(len(s_perm)):
        if s_perm[i] is None:
            s_perm[i] = next(fill)
    return a_sorted, s_perm


def _shplonk_open(pk, fp: FusedPhases, t, queries, rot_point, ucoeff):
    """BDFG20 batch opening. queries: [(label, rot, eval_int)]."""
    dev = ucoeff.device
    by_poly = []  # (label, {rot: eval})
    seen = {}
    for label, rot, ev in queries:
        if label not in seen:
            seen[label] = len(by_poly)
            by_poly.append((label, {}))
        by_poly[seen[label]][1][rot] = ev

    sets: dict[tuple, list] = {}
    for label, rmap in by_poly:
        rkey = tuple(sorted(rmap.keys()))
        sets.setdefault(rkey, []).append((label, rmap))
    set_list = sorted(sets.items(), key=lambda kv: kv[0])

    y_ch = t.squeeze_challenge()
    v_ch = t.squeeze_challenge()

    set_struct = []
    r_polys_list = []
    pts_list = []
    set_aux = []  # (pts, r_poly)
    for rkey, polys in set_list:
        members = tuple(fp.uidx(lbl) for lbl, _ in polys)
        set_struct.append((len(rkey), members))
        pts = [rot_point(r) for r in rkey]
        evs = []
        for r in rkey:
            acc = 0
            for _lbl, rmap in polys:
                acc = (acc * v_ch + rmap[r]) % R
            evs.append(acc)
        r_poly = _interp(pts, evs)
        set_aux.append((pts, r_poly))
        r_polys_list.append(torch.as_tensor(SPEC.encode(r_poly)).to(dev))
        pts_list.append(torch.as_tensor(SPEC.encode(pts)).to(dev))

    h_coeff, F_list = fp.shplonk_h(
        tuple(set_struct), ucoeff, _mont_const(v_ch, dev),
        _mont_const(y_ch, dev), r_polys_list, pts_list)
    t.write_point(commit_coeff(pk.srs, h_coeff))

    u_ch = t.squeeze_challenge()

    all_pts = sorted({p for pts, _ in set_aux for p in pts})
    z_t_u = 1
    for p_ in all_pts:
        z_t_u = z_t_u * (u_ch - p_) % R
    scales, rus = [], []
    for pts, r_poly in set_aux:
        z_s_u = 1
        for p_ in pts:
            z_s_u = z_s_u * (u_ch - p_) % R
        scales.append(z_t_u * pow(z_s_u, R - 2, R) % R)
        r_u = 0
        for c in reversed(r_poly):
            r_u = (r_u * u_ch + c) % R
        rus.append(r_u)
    W_coeff = fp.shplonk_w(
        len(set_list), F_list, h_coeff, _mont_const(y_ch, dev),
        torch.as_tensor(SPEC.encode(scales)).to(dev),
        torch.as_tensor(SPEC.encode(rus)).to(dev),
        _mont_const(z_t_u, dev), _mont_const(u_ch, dev))
    t.write_point(commit_coeff(pk.srs, W_coeff))


def _gwc_open(pk, fp: FusedPhases, t, queries, rot_point, ucoeff):
    """GWC19 batch opening (the EVM path): one witness commitment per
    distinct rotation, the groups in first-occurrence order of `queries`."""
    dev = ucoeff.device
    v = t.squeeze_challenge()
    groups: dict[int, list] = {}
    for label, rot, ev in queries:
        groups.setdefault(rot, []).append((label, ev))

    group_struct, rcomb_list, zpt_list = [], [], []
    for rot, polys in groups.items():
        group_struct.append(tuple(fp.uidx(lbl) for lbl, _ in polys))
        r_comb = 0
        for _lbl, ev in polys:
            r_comb = (r_comb * v + ev) % R
        rcomb_list.append(_mont_const(r_comb, dev))
        zpt_list.append(_mont_const(rot_point(rot), dev))
    W_list = fp.gwc_w(tuple(group_struct), ucoeff, _mont_const(v, dev),
                      rcomb_list, zpt_list)
    # one batch: the points do not depend on it, the transcript order stays
    for pt in commit_coeff_batch(pk.srs, torch.stack(W_list, dim=1)):
        t.write_point(pt)


def _interp(pts: list[int], evs: list[int]) -> list[int]:
    """Host Lagrange interpolation -> coefficient list (low-first)."""
    k = len(pts)
    coeffs = [0] * k
    for i in range(k):
        num = [1]
        denom = 1
        for j in range(k):
            if j == i:
                continue
            num = _polymul(num, [(-pts[j]) % R, 1])
            denom = denom * (pts[i] - pts[j]) % R
        scale = evs[i] * pow(denom, R - 2, R) % R
        for d, c in enumerate(num):
            coeffs[d] = (coeffs[d] + c * scale) % R
    return coeffs


def _polymul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = (out[i + j] + ai * bj) % R
    return out


# ---------------------------------------------------------------------------
# quotient constraint evaluation (used by fused.FusedPhases.quotient)
# ---------------------------------------------------------------------------

def _quotient_core(cs: CS.ConstraintSystem, u: int, ratio: int,
                   offsets: dict, na: int, ni: int, nz: int, nlk: int,
                   chunks: int = 1):
    """The h_ext evaluation over stacked extended tensors (8, B, ext_n),
    over `chunks` windows [s, s + C) of the extended domain, C = ext_n /
    chunks (WH2_QUOTIENT_CHUNKS, the JAX package's memory mode; 1 is the
    whole domain in one window), one after another, joined. Every term is
    pointwise in the extended axis except rotations, so a window of a
    tensor rotated by rot is the circular window [s + rot * ratio, ...) of
    its source: at most two slices (one window of the whole domain gives a
    roll). The temporaries of each constraint are (8, C), and the values
    are the same for every count."""
    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.perm_columns
    adv_off, inst_off = offsets["adv"], offsets["inst"]
    z_off, lk_off = offsets["z"], offsets["lk"]

    def core(fixed_ext, sigma_ext, ext_stack, l0, llast, lblind, x_ext,
             zh_inv, beta_t, gamma_t, y_t):
        def body(get):
            return _quotient_body(
                cs, u, chunk_len, perm_cols, adv_off, inst_off, z_off, lk_off,
                nz, nlk, fixed_ext, sigma_ext, ext_stack, l0, llast, lblind,
                x_ext, zh_inv, beta_t, gamma_t, y_t, get)

        ext_n = zh_inv.shape[-1]
        if chunks < 1 or ext_n % chunks:
            raise ValueError(f"WH2_QUOTIENT_CHUNKS={chunks} does not divide the "
                             f"extended domain of {ext_n} rows")
        C = ext_n // chunks

        def window(src, start):
            start %= ext_n
            if start + C <= ext_n:
                return src[..., start:start + C]
            return torch.cat([src[..., start:], src[..., :start + C - ext_n]], dim=-1)

        parts = [body(lambda src, rot, s=s: window(src, s + rot * ratio))
                 for s in range(0, ext_n, C)]
        return parts[0] if chunks == 1 else torch.cat(parts, dim=-1)

    return core


def _quotient_body(cs, u, chunk_len, perm_cols, adv_off, inst_off, z_off,
                   lk_off, nz, nlk, fixed_ext, sigma_ext, ext_stack, l0,
                   llast, lblind, x_ext, zh_inv, beta_t, gamma_t, y_t, get):
    """One evaluation of the full gate system through `get(src, rot)`."""
    dev = ext_stack.device

    def col_getter_ext(kind, idx, rot):
        if kind == CS.FIXED:
            src_ = fixed_ext[:, idx]
        elif kind == CS.ADVICE:
            src_ = ext_stack[:, adv_off + idx]
        else:
            src_ = ext_stack[:, inst_off + idx]
        return get(src_, rot)

    def Wd(t):
        return get(t, 0)

    perm_z_raw = [ext_stack[:, z_off + i] for i in range(nz)]
    l0, llast, lblind = Wd(l0), Wd(llast), Wd(lblind)
    x_ext, zh_inv = Wd(x_ext), Wd(zh_inv)

    one_t = M.one_mont(SPEC, dev)
    active = M.sub(SPEC, one_t, M.add(SPEC, llast, lblind))

    constraints = []
    for _, g in cs.gates:
        constraints.append(CS.eval_device(g, col_getter_ext, dev))
    if perm_cols:
        constraints.append(
            M.montmul(SPEC, l0, M.sub(SPEC, one_t, Wd(perm_z_raw[0]))))
        zl = Wd(perm_z_raw[-1])
        constraints.append(
            M.montmul(SPEC, llast, M.sub(SPEC, M.montsquare(SPEC, zl), zl)))
        for i in range(1, nz):
            constraints.append(M.montmul(
                SPEC, l0, M.sub(SPEC, Wd(perm_z_raw[i]), get(perm_z_raw[i - 1], u))))
        for ci, cstart in enumerate(range(0, len(perm_cols), chunk_len)):
            chunk = range(cstart, min(cstart + chunk_len, len(perm_cols)))
            left = get(perm_z_raw[ci], 1)
            right = Wd(perm_z_raw[ci])
            for j in chunk:
                kind, idx = perm_cols[j]
                v = col_getter_ext(kind, idx, 0)
                dj_t = M.const(SPEC, pow(BN254_FR_DELTA, j, R), dev)
                idv = M.montmul(SPEC, dj_t, x_ext)
                left = M.montmul(SPEC, left, M.add(SPEC, M.add(
                    SPEC, v, M.montmul(SPEC, beta_t, Wd(sigma_ext[:, j]))), gamma_t))
                right = M.montmul(SPEC, right, M.add(SPEC, M.add(
                    SPEC, v, M.montmul(SPEC, beta_t, idv)), gamma_t))
            constraints.append(M.montmul(SPEC, active, M.sub(SPEC, left, right)))
    for li in range(nlk):
        z_src = ext_stack[:, lk_off + 5 * li]
        ap_src = ext_stack[:, lk_off + 5 * li + 1]
        z_e = Wd(z_src)
        z_n = get(z_src, 1)
        ap = Wd(ap_src)
        sp = Wd(ext_stack[:, lk_off + 5 * li + 2])
        inp = Wd(ext_stack[:, lk_off + 5 * li + 3])
        tab = Wd(ext_stack[:, lk_off + 5 * li + 4])
        ap_prev = get(ap_src, -1)
        constraints.append(M.montmul(SPEC, l0, M.sub(SPEC, one_t, z_e)))
        constraints.append(
            M.montmul(SPEC, llast, M.sub(SPEC, M.montsquare(SPEC, z_e), z_e)))
        lhs = M.montmul(SPEC, z_n, M.montmul(
            SPEC, M.add(SPEC, ap, beta_t), M.add(SPEC, sp, gamma_t)))
        rhs = M.montmul(SPEC, z_e, M.montmul(
            SPEC, M.add(SPEC, inp, beta_t), M.add(SPEC, tab, gamma_t)))
        constraints.append(M.montmul(SPEC, active, M.sub(SPEC, lhs, rhs)))
        constraints.append(M.montmul(SPEC, active, M.montmul(
            SPEC, M.sub(SPEC, ap, sp), M.sub(SPEC, ap, ap_prev))))
        constraints.append(M.montmul(SPEC, l0, M.sub(SPEC, ap, sp)))

    h_ext = constraints[0]
    for c in constraints[1:]:
        h_ext = M.add(SPEC, M.montmul(SPEC, h_ext, y_t), c)
    return M.montmul(SPEC, h_ext, zh_inv)
