"""Prover phases: every segment between two transcript interactions.

The port of the JAX package's plonk/fused.py. There each segment is one
jitted, AOT-cached graph, because its TPU backend paid for every dispatch
and every compile. PyTorch runs eagerly, so here each phase is a plain
function over word tensors; the order of the field operations, and so
every value, is the JAX package's.

Stacks of columns are (8, B, n): word-major, then column, then row.
"""
from __future__ import annotations

import functools
import os

import torch

from ..device import cached
from ..fields.constants import BN254_FR, BN254_FR_DELTA
from ..fields.limbs import FR_SPEC, W
from ..ops import modops as M
from ..ops import ntt as N
from ..ops import poly as P
from . import cs as CS
from .domain import COSET_GEN, Domain

R = BN254_FR
SPEC = FR_SPEC


def _one(device, ndim: int = 2) -> torch.Tensor:
    return M.one_mont(SPEC, device, ndim)


# ---------------------------------------------------------------------------
# circuit-independent phases
# ---------------------------------------------------------------------------

def to_mont_stack(x: torch.Tensor) -> torch.Tensor:
    """(8, B, n) standard words -> Montgomery form."""
    return M.to_mont(SPEC, x)


def to_mont_split(x: torch.Tensor, na: int):
    """(8, A+I, n) standard words -> (advice (8, A, n), instance (8, I, n))."""
    m = M.to_mont(SPEC, x)
    return m[:, :na], m[:, na:]


def batched_l2c(k: int, stack: torch.Tensor) -> torch.Tensor:
    """Lagrange -> coefficients for every column of an (8, B, n) stack;
    over the ranks under WH2_SHARDED=1 (parallel/sharded.py)."""
    from ..parallel import sharded as S

    mesh = S.ntt_mesh("l2c", k, stack.device)
    if mesh is not None:
        return S.sharded_intt(mesh, stack, k)
    return N.intt(SPEC, stack, k)


def batched_c2e(k: int, ext_k: int, stack: torch.Tensor) -> torch.Tensor:
    """Coefficients -> extended coset evaluations, (8, B, n) -> (8, B, ext_n);
    over the ranks under WH2_SHARDED=1 (parallel/sharded.py)."""
    from ..parallel import sharded as S

    mesh = S.ntt_mesh("c2e", ext_k, stack.device)
    if mesh is not None:
        return S.sharded_coeff_to_extended(mesh, stack, k, ext_k)
    return Domain(k, ext_k).coeff_to_extended(stack)


def powers_of(w_mont: torch.Tensor, scale_mont: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n) Montgomery tensor of scale * w^i."""
    return M.montmul(SPEC, scale_mont, P.power_table(SPEC, w_mont, n))


@functools.lru_cache(maxsize=8)
def _coset_points_np(k: int):
    n = 1 << k
    w = N.root_of_unity(k)
    xs = []
    acc = COSET_GEN
    for _ in range(n):
        xs.append(acc)
        acc = acc * w % R
    return SPEC.encode(xs)


def coset_points(k: int, device) -> torch.Tensor:
    """(8, n) Montgomery tensor of the coset g * w^i (the SHPLONK domain)."""
    return cached(("coset", k), lambda: _coset_points_np(k), device)


def _scan_z(num, den, carry, n: int, usable: int):
    """z[0] = carry; z[i+1] = z[i] * num[i] / den[i] on active rows."""
    dev = num.device
    den_inv = M.batch_inverse(SPEC, den, axis=1)
    ratio = M.montmul(SPEC, num, den_inv)
    mask = (torch.arange(n, device=dev) < usable)[None, :]
    ratio = torch.where(mask, ratio, _one(dev).expand(ratio.shape))
    incl = M.prefix_mul(SPEC, ratio, 1)
    z = torch.cat([_one(dev), incl[:, :-1]], dim=1)
    return M.montmul(SPEC, carry, z)


# ---------------------------------------------------------------------------
# the per-circuit phases
# ---------------------------------------------------------------------------

class FusedPhases:
    """The phase functions of one ProvingKey and its unified indexing."""

    def __init__(self, pk):
        self.pk = pk
        cs_ = pk.vk.cs
        self.cs = cs_
        self.domain: Domain = pk.vk.domain
        self.n = self.domain.n
        self.usable = cs_.usable_rows(self.n)
        self.na = cs_.num_advice
        self.ni = cs_.num_instance
        self.nz = cs_.num_perm_chunks()
        self.nlk = len(cs_.lookups)
        self.nf = cs_.num_fixed
        self.nsig = len(cs_.perm_columns)
        # unified multiopen rows: [advice | instance | perm_z |
        # lookup{z,ap,sp,in,tab}*nlk | random] ++ fixed ++ sigma ++ h
        self.m_stack = self.na + self.ni + self.nz + 5 * self.nlk + 1
        self.u_fixed = self.m_stack
        self.u_sigma = self.m_stack + self.nf
        self.u_h = self.u_sigma + self.nsig
        self.u_total = self.u_h + 1

    def uidx(self, label) -> int:
        """query label -> row in the unified multiopen stack."""
        kind = label[0]
        if kind == CS.ADVICE:
            return label[1]
        if kind == CS.INSTANCE:
            return self.na + label[1]
        if kind == "perm_z":
            return self.na + self.ni + label[1]
        if kind in ("lookup_z", "lookup_ap", "lookup_sp"):
            off = {"lookup_z": 0, "lookup_ap": 1, "lookup_sp": 2}[kind]
            return self.na + self.ni + self.nz + 5 * label[1] + off
        if kind == "random":
            return self.na + self.ni + self.nz + 5 * self.nlk
        if kind == CS.FIXED:
            return self.u_fixed + label[1]
        if kind == "sigma":
            return self.u_sigma + label[1]
        if kind == "h":
            return self.u_h
        raise KeyError(label)

    # -- phase 2: lookup input/table compression ----------------------------
    def lookup_compress(self, fixed_s, advice_s, instance_s, theta_t):
        """-> ((8, 2*nlk, n) Montgomery, the same in standard form)."""
        dev = advice_s.device
        srcs = {CS.FIXED: fixed_s, CS.ADVICE: advice_s, CS.INSTANCE: instance_s}

        def getter(kind, idx, rot):
            src = srcs[kind][:, idx]
            return torch.roll(src, -rot, dims=-1) if rot else src

        def compress(exprs):
            acc = None
            for e in exprs:
                v = CS.eval_device(e, getter, dev)
                acc = v if acc is None else M.add(
                    SPEC, M.montmul(SPEC, acc, theta_t), v)
            return acc

        outs = []
        for lk in self.cs.lookups:
            outs.append(compress(lk.inputs))
            outs.append(compress(lk.tables))
        mont = torch.stack(outs, dim=1)
        return mont, M.normalize(SPEC, M.from_mont(SPEC, mont))

    # -- phases 3-5: grand products + random poly ---------------------------
    def _gp_chunk(self, ci, advice_s, fixed_s, instance_s, sigma_s, omega_m,
                  beta, gamma, carry):
        cs_ = self.cs
        chunk_len = cs_.permutation_chunk_len()
        perm_cols = cs_.perm_columns
        chunk = range(ci * chunk_len, min((ci + 1) * chunk_len, len(perm_cols)))
        srcs = {CS.FIXED: fixed_s, CS.ADVICE: advice_s, CS.INSTANCE: instance_s}
        dev = advice_s.device
        num = den = None
        for j in chunk:
            kind, idx = perm_cols[j]
            v = srcs[kind][:, idx]
            dj = M.const(SPEC, pow(BN254_FR_DELTA, j, R), dev)
            idv = M.montmul(SPEC, dj, omega_m)
            nt = M.add(SPEC, M.add(SPEC, v, M.montmul(SPEC, beta, idv)), gamma)
            dt = M.add(SPEC, M.add(
                SPEC, v, M.montmul(SPEC, beta, sigma_s[:, j])), gamma)
            num = nt if num is None else M.montmul(SPEC, num, nt)
            den = dt if den is None else M.montmul(SPEC, den, dt)
        z = _scan_z(num, den, carry, self.n, self.usable)
        return z, z[:, self.usable:self.usable + 1]

    def _gp_lookup(self, li, lkm, lkp, beta, gamma):
        num = M.montmul(SPEC, M.add(SPEC, lkm[:, 2 * li], beta),
                        M.add(SPEC, lkm[:, 2 * li + 1], gamma))
        den = M.montmul(SPEC, M.add(SPEC, lkp[:, 2 * li], beta),
                        M.add(SPEC, lkp[:, 2 * li + 1], gamma))
        return _scan_z(num, den, _one(num.device), self.n, self.usable)

    def grand_products(self, advice_s, fixed_s, instance_s, sigma_s, omega_m,
                       beta_t, gamma_t, lk_mont, lk_perm_mont, tails_std,
                       random_std):
        """Permutation z chunks (carry-chained), lookup z's, tail blinding
        and the vanishing random polynomial.
        Returns (z_stack (8, nz+nlk, n), random_lag (8, n), commit_stack)."""
        zs = []
        carry = _one(advice_s.device)
        for ci in range(self.nz):
            z, carry = self._gp_chunk(ci, advice_s, fixed_s, instance_s,
                                      sigma_s, omega_m, beta_t, gamma_t, carry)
            zs.append(z)
        for li in range(self.nlk):
            zs.append(self._gp_lookup(li, lk_mont, lk_perm_mont, beta_t, gamma_t))
        z_stack = torch.stack(zs, dim=1)
        if tails_std.shape[-1]:
            z_stack[:, :, self.usable + 1:] = M.to_mont(SPEC, tails_std)
        rnd = M.to_mont(SPEC, random_std)
        return z_stack, rnd, torch.cat([z_stack, rnd[:, None]], dim=1)

    # -- quotient input assembly --------------------------------------------
    def lag_stack(self, adv, inst, zs, lkp, lkm, rnd):
        """Rows: [advice | instance | perm z | per-lookup (z, a', s',
        compressed-in, compressed-tab) | random]."""
        rows = [adv[:, i] for i in range(self.na)]
        rows += [inst[:, i] for i in range(self.ni)]
        rows += [zs[:, i] for i in range(self.nz)]
        for li in range(self.nlk):
            rows += [zs[:, self.nz + li], lkp[:, 2 * li], lkp[:, 2 * li + 1],
                     lkm[:, 2 * li], lkm[:, 2 * li + 1]]
        rows.append(rnd)
        return torch.stack(rows, dim=1)

    # -- phase 6: quotient ---------------------------------------------------
    def quotient(self, ext_stack, beta_t, gamma_t, y_t):
        """-> the quotient pieces in coefficient form, (8, pieces, n). h is
        evaluated over WH2_QUOTIENT_CHUNKS windows of the extended domain
        (read at each call; default 1, the whole domain at once), which
        changes the peak memory and the launch shapes, never the values."""
        from .prover import _quotient_core

        cs_ = self.cs
        pk = self.pk
        ratio = self.domain.ext_n // self.n
        offsets = dict(adv=0, inst=self.na, z=self.na + self.ni,
                       lk=self.na + self.ni + self.nz)
        num_pieces = cs_.degree() - 1
        n = self.n
        dev = ext_stack.device
        core = _quotient_core(cs_, self.usable, ratio, offsets, self.na,
                              self.ni, self.nz, self.nlk,
                              chunks=int(os.environ.get("WH2_QUOTIENT_CHUNKS", "1")))
        zh_inv = cached(("zhinv", self.domain.k, self.domain.extended_k),
                              self.domain.zh_inv_extended_np, dev)
        h_ext = core(pk.fixed_ext, pk.sigma_ext, ext_stack, pk.l0_ext,
                     pk.llast_ext, pk.lblind_ext, pk.x_ext, zh_inv, beta_t,
                     gamma_t, y_t)
        h_coeff = self.domain.extended_to_coeff(h_ext)
        return torch.stack([h_coeff[:, i * n:(i + 1) * n]
                            for i in range(num_pieces)], dim=1)

    # -- phase 7: evaluations -------------------------------------------------
    def evals(self, plan, rots, coeff_s, fixed_s, sigma_s, h_p, pts, xn):
        """plan: list of (unified_label, rot); rots: sorted distinct rots.
        Returns (evals_std (8, Q), h_combined (8, n), h_eval_std (8, 1))."""
        n = self.n
        num_pieces = self.cs.degree() - 1
        rot_pos = {r: i for i, r in enumerate(rots)}
        pows = [P.power_table(SPEC, pts[:, i:i + 1], n) for i in range(len(rots))]
        h_comb = h_p[:, num_pieces - 1]
        for i in range(num_pieces - 2, -1, -1):
            h_comb = M.add(SPEC, M.montmul(SPEC, h_comb, xn), h_p[:, i])

        def poly_of(ui):
            if ui < self.m_stack:
                return coeff_s[:, ui]
            if ui < self.u_sigma:
                return fixed_s[:, ui - self.u_fixed]
            if ui < self.u_h:
                return sigma_s[:, ui - self.u_sigma]
            return h_comb

        plan_key = [(self.uidx(lbl), rot) for lbl, rot in plan]
        stacked = torch.stack([poly_of(ui) for ui, _ in plan_key], dim=1)
        pw = torch.stack([pows[rot_pos[r]] for _, r in plan_key], dim=1)
        ev = P.mod_sum(SPEC, M.montmul(SPEC, stacked, pw))[..., 0]
        ev_std = M.normalize(SPEC, M.from_mont(SPEC, ev))
        h_ev = P.eval_at(SPEC, h_comb, pows[rot_pos[0]])
        return ev_std, h_comb, M.normalize(SPEC, M.from_mont(SPEC, h_ev))

    # -- phase 8: SHPLONK ------------------------------------------------------
    def _shp_set(self, npts, members, uc, v, r_poly, pts_sel, xs_coset):
        n = self.n
        k = self.domain.k
        F = uc[:, members[0]]
        for ui in members[1:]:
            F = M.add(SPEC, M.montmul(SPEC, F, v), uc[:, ui])
        r_pad = torch.cat([r_poly, torch.zeros((W, n - r_poly.shape[1]),
                                               dtype=torch.int32,
                                               device=r_poly.device)], dim=1)
        r_cos = N.ntt(SPEC, N.coset_shift(SPEC, r_pad, COSET_GEN), k)
        F_cos = N.ntt(SPEC, N.coset_shift(SPEC, F, COSET_GEN), k)
        num = M.sub(SPEC, F_cos, r_cos)
        zs = None
        for pi in range(npts):
            term = M.sub(SPEC, xs_coset, pts_sel[:, pi:pi + 1])
            zs = term if zs is None else M.montmul(SPEC, zs, term)
        return F, M.montmul(SPEC, num, M.batch_inverse(SPEC, zs, axis=1))

    def shplonk_h(self, set_struct, ucoeff, v_t, y_t, r_polys_list, pts_list):
        """set_struct: (n_pts, (unified_idx...)) per set, in sorted set
        order. Returns (h_coeff (8, n), F_list [(8, n)])."""
        k = self.domain.k
        xs_coset = coset_points(k, ucoeff.device)
        F_list, nums = [], []
        for s_i, (npts, members) in enumerate(set_struct):
            F, num = self._shp_set(npts, members, ucoeff, v_t,
                                   r_polys_list[s_i], pts_list[s_i], xs_coset)
            F_list.append(F)
            nums.append(num)
        h_total = nums[0]
        for num in nums[1:]:
            h_total = M.add(SPEC, M.montmul(SPEC, h_total, y_t), num)
        ginv = pow(COSET_GEN, R - 2, R)
        return N.coset_shift(SPEC, N.intt(SPEC, h_total, k), ginv), F_list

    def shplonk_w(self, n_sets, F_list, h_c, y, scale, ru, ztu, u):
        """F_list: (8, n) per set; scale/ru: (8, S). Returns W_coeff (8, n)."""
        k = self.domain.k
        xs_coset = coset_points(k, h_c.device)
        L_poly = None
        for s_i in range(n_sets):
            sc = scale[:, s_i:s_i + 1]
            term = M.montmul(SPEC, sc, F_list[s_i])
            term[:, 0:1] = M.sub(SPEC, term[:, 0:1],
                                 M.montmul(SPEC, sc, ru[:, s_i:s_i + 1]))
            L_poly = term if L_poly is None else M.add(
                SPEC, M.montmul(SPEC, L_poly, y), term)
        L_poly = M.sub(SPEC, L_poly, M.montmul(SPEC, ztu, h_c))
        L_cos = N.ntt(SPEC, N.coset_shift(SPEC, L_poly, COSET_GEN), k)
        den = M.sub(SPEC, xs_coset, u)
        W_cos = M.montmul(SPEC, L_cos, M.batch_inverse(SPEC, den, axis=1))
        ginv = pow(COSET_GEN, R - 2, R)
        return N.coset_shift(SPEC, N.intt(SPEC, W_cos, k), ginv)

    # -- phase 8 (GWC): one witness a rotation group -------------------------
    def _gwc_one(self, members, uc, v, rcomb, zpt, xs_coset):
        k = self.domain.k
        F = uc[:, members[0]]
        for ui in members[1:]:
            F = M.add(SPEC, M.montmul(SPEC, F, v), uc[:, ui])
        # a group of one leaves F a view of uc: build it anew, never in place
        F = torch.cat([M.sub(SPEC, F[:, 0:1], rcomb), F[:, 1:]], dim=1)
        F_cos = N.ntt(SPEC, N.coset_shift(SPEC, F, COSET_GEN), k)
        den = M.sub(SPEC, xs_coset, zpt)
        W_cos = M.montmul(SPEC, F_cos, M.batch_inverse(SPEC, den, axis=1))
        ginv = pow(COSET_GEN, R - 2, R)
        return N.coset_shift(SPEC, N.intt(SPEC, W_cos, k), ginv)

    def gwc_w(self, group_struct, ucoeff, v_t, rcomb_list, zpts_list):
        """group_struct: (unified_idx...) per rotation group, in
        first-occurrence order; rcomb_list/zpts_list: (8, 1) per group.
        Returns W_coeff (8, n) per group: (F - r_comb) / (X - z)."""
        xs_coset = coset_points(self.domain.k, ucoeff.device)
        return [self._gwc_one(members, ucoeff, v_t, rcomb_list[g_i],
                              zpts_list[g_i], xs_coset)
                for g_i, members in enumerate(group_struct)]

    # -- unified multiopen stack ---------------------------------------------
    def unified_stack(self, coeff_stack, fixed_coeff, sigma_coeff, h_combined):
        parts = [coeff_stack]
        if self.nf:
            parts.append(fixed_coeff)
        if self.nsig:
            parts.append(sigma_coeff)
        parts.append(h_combined[:, None])
        return torch.cat(parts, dim=1)
