"""Key generation: vk/pk from a constraint system + fixed assignment.

The port of the JAX package's plonk/keygen.py. Produces:
  * vk: fixed-column and permutation-sigma commitments + a transcript
    digest binding the whole circuit description (byte-identical to the
    JAX package's for the same circuit and SRS);
  * pk: device polynomial tensors in all three bases, the sigma tables,
    and the Lagrange-indicator polynomials (l_0, l_last, l_blind) on the
    extended coset.
Every commitment goes through `MSM_ENGINE`, the v3 MSM pipeline
(ops/msm_fused.py, the JAX package's `msm_hostout` route), and comes back
as host affine ints.
"""
from __future__ import annotations

import hashlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields.constants import BN254_FR, BN254_FR_DELTA
from ..fields.limbs import FR_SPEC, W, ints_to_words
from ..ops import ec as E
from ..ops import modops as M
from ..ops import msm_fused
from ..device import fence, resolve, tracing
from . import cs as CS
from .domain import COSET_GEN, Domain
from .srs import SRS
from .transcript import compress_g1

R = BN254_FR
DELTA = BN254_FR_DELTA


def encode_column(vals: list[int], device) -> torch.Tensor:
    """Host int column -> (8, n) device Montgomery tensor."""
    std = torch.as_tensor(ints_to_words([v % R for v in vals])).to(device)
    return M.to_mont(FR_SPEC, std)


def _batch_input(cols):
    """list of (8, n) -> (8, B, n); an (8, B, n) stack passes through."""
    if isinstance(cols, (list, tuple)):
        if not cols:
            return None, 0
        return torch.stack(list(cols), dim=1), len(cols)
    return cols, cols.shape[1]


# The commit engine, read here and nowhere else: a module with `msm_batch`
# and `msm`. Two other engines give the same affine points, so the same
# proof bytes, and the checks that compare routes set this to them: the
# v1 driver of ops/msm_v1.py (the JAX package's WH2_MSM_V3=0) and the serial
# Pippenger of ops/msm.py, the plain reference (WH2_MSM_IMPL=xla
# WH2_PALLAS=1).
MSM_ENGINE = msm_fused


def commit_lagrange_batch(srs: SRS, cols) -> list:
    """Commit many Lagrange columns (list of (8, n) or an (8, B, n) stack).
    Under WH2_SHARDED=1 in a group of two or more ranks, the point axis of
    each commit is split over the ranks (parallel/sharded.py)."""
    from ..parallel import sharded as S

    stack, B = _batch_input(cols)
    if not B:
        return []
    mesh = S.commit_mesh(stack.device)
    if mesh is not None:
        return S.sharded_msm_batch(mesh, srs.g_lag, stack, engine=MSM_ENGINE)
    return MSM_ENGINE.msm_batch(E.BN254_CURVE, srs.g_lag, stack)


def commit_coeff_batch(srs: SRS, cols) -> list:
    stack, B = _batch_input(cols)
    if not B:
        return []
    return MSM_ENGINE.msm_batch(E.BN254_CURVE, srs.g_mono, stack)


def commit_coeff(srs: SRS, coeffs_mont: torch.Tensor):
    return MSM_ENGINE.msm(E.BN254_CURVE, srs.g_mono, coeffs_mont)


@dataclass
class VerifyingKey:
    domain: Domain
    cs: CS.ConstraintSystem
    fixed_commitments: list
    perm_commitments: list
    transcript_repr: int

    def hash_into(self, transcript) -> None:
        transcript.common_scalar(self.transcript_repr)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    srs: SRS
    device: torch.device
    fixed_lagrange: list  # (8, n) per fixed column
    fixed_coeff: list
    fixed_ext: torch.Tensor  # (8, nf, ext_n)
    sigma_lagrange: list  # (8, n) per permutation column
    sigma_coeff: list
    sigma_ext: torch.Tensor  # (8, nsig, ext_n)
    l0_ext: torch.Tensor  # indicator polys on the extended coset, (8, ext_n)
    llast_ext: torch.Tensor
    lblind_ext: torch.Tensor
    x_ext: torch.Tensor  # coset points X on the extended domain
    omega_mont: torch.Tensor  # (8, n) Montgomery omega^i
    spans: dict = field(default_factory=dict)


def _domain_for(cs: CS.ConstraintSystem, k: int) -> Domain:
    d = cs.degree()
    ext = 0
    while (1 << ext) < d - 1:
        ext += 1
    return Domain(k, k + ext)


def assemble_permutation(cs: CS.ConstraintSystem, n: int, copies: list):
    """Cycle-build sigma: start from identity, swap targets per copy pair.
    Returns sigma as (num_cols, n, 2) array of (col, row) targets."""
    col_pos = {c: i for i, c in enumerate(cs.perm_columns)}
    ncols = len(cs.perm_columns)
    mapping = np.empty((ncols, n, 2), dtype=np.int64)
    for j in range(ncols):
        mapping[j, :, 0] = j
        mapping[j, :, 1] = np.arange(n)
    for (ka, ia, ra), (kb, ib, rb) in copies:
        a = (col_pos[(ka, ia)], ra)
        b = (col_pos[(kb, ib)], rb)
        tmp = mapping[a[0], a[1]].copy()
        mapping[a[0], a[1]] = mapping[b[0], b[1]]
        mapping[b[0], b[1]] = tmp
    return mapping


def _pack(cols: list, n: int, device) -> torch.Tensor:
    """(8, len(cols), n) canonical words of the columns, each zero-padded to
    n. A column longer than n raises ValueError, as the JAX package's
    packing does (the reference circuit's constants column at k = 11 and
    12 holds more constants than 2^k rows)."""
    flat: list[int] = []
    for i, col in enumerate(cols):
        if len(col) > n:
            raise ValueError(f"fixed column {i} has {len(col)} rows, more than n = {n}")
        flat.extend(int(v) % R for v in col)
        flat.extend([0] * (n - len(col)))
    return torch.as_tensor(ints_to_words(flat).reshape(W, len(cols), n)).to(device)


def keygen(srs: SRS, cs: CS.ConstraintSystem, fixed_cols: list, copies: list,
           device=None) -> ProvingKey:
    """keygen_vk + keygen_pk on `device` (None: the current card), where the
    SRS must already lie: an SRS on another device raises."""
    from .fused import batched_c2e, batched_l2c, powers_of, to_mont_stack

    dev = srs.g_lag.x.device
    if resolve(device) != dev:
        raise ValueError(f"SRS lies on {dev}, keygen asked for {device}")
    spans: dict[str, float] = {}
    clock = [time.time()]

    def span(name):
        """The seconds since the last span, only under WH2_TRACE: fenced,
        kept in pk.spans and printed, as the JAX package's keygen does."""
        if not tracing():
            return
        fence(dev)
        now = time.time()
        spans[name] = now - clock[0]
        clock[0] = now
        print(f"[span] {name}: {spans[name]:.3f}s", file=sys.stderr, flush=True)

    k = srs.k
    n = 1 << k
    domain = _domain_for(cs, k)
    assert len(fixed_cols) == cs.num_fixed
    empty = torch.zeros((W, 0, domain.ext_n), dtype=torch.int32, device=dev)

    fixed_lagrange, fixed_coeff, fixed_ext = [], [], empty
    if fixed_cols:
        lag_stack = to_mont_stack(_pack(fixed_cols, n, dev))
        coeff_stack = batched_l2c(k, lag_stack)
        fixed_ext = batched_c2e(k, domain.extended_k, coeff_stack)
        fixed_lagrange = [lag_stack[:, i] for i in range(len(fixed_cols))]
        fixed_coeff = [coeff_stack[:, i] for i in range(len(fixed_cols))]
    span("fixed cols")
    fixed_comms = commit_lagrange_batch(srs, fixed_lagrange)
    span("fixed commits")

    omega = domain.omega
    one_m = M.const(FR_SPEC, 1, dev)
    omega_mont = powers_of(torch.as_tensor(FR_SPEC.encode([omega])).to(dev),
                           one_m, n)
    ncols = len(cs.perm_columns)
    mapping = assemble_permutation(cs, n, copies)
    span("assemble perm")
    sigma_lagrange, sigma_coeff, sigma_ext = [], [], empty
    if ncols:
        delta_mont = torch.as_tensor(
            FR_SPEC.encode([pow(DELTA, j, R) for j in range(ncols)])).to(dev)
        tgt_col = torch.as_tensor(mapping[:, :, 0]).to(dev)  # (ncols, n)
        tgt_row = torch.as_tensor(mapping[:, :, 1]).to(dev)
        # sigma_j[i] = delta^(target col) * omega^(target row)
        sig_stack = M.montmul(FR_SPEC, delta_mont[:, tgt_col],
                              omega_mont[:, tgt_row])  # (8, ncols, n)
        sig_coeff_stack = batched_l2c(k, sig_stack)
        sigma_ext = batched_c2e(k, domain.extended_k, sig_coeff_stack)
        sigma_lagrange = [sig_stack[:, j] for j in range(ncols)]
        sigma_coeff = [sig_coeff_stack[:, j] for j in range(ncols)]
    span("sigma polys")
    perm_comms = commit_lagrange_batch(srs, sigma_lagrange) if sigma_lagrange else []
    span("sigma commits")

    # row layout: data rows [0, usable); boundary row `usable` (the grand
    # products' final value); blinding rows (usable, n)
    u = cs.usable_rows(n)
    l0 = [0] * n
    l0[0] = 1
    llast = [0] * n
    llast[u] = 1
    lblind = [0] * n
    for i in range(u + 1, n):
        lblind[i] = 1
    ind = torch.stack([encode_column(c, dev) for c in (l0, llast, lblind)], dim=1)
    ind_ext = domain.coeff_to_extended(domain.lagrange_to_coeff(ind))
    l0_ext, llast_ext, lblind_ext = (ind_ext[:, i] for i in range(3))
    span("indicator polys")

    ext_n = domain.ext_n
    wext = domain.omega_ext
    xs = [0] * ext_n
    accx = COSET_GEN
    for i in range(ext_n):
        xs[i] = accx
        accx = accx * wext % R
    x_ext = encode_column(xs, dev)
    span("x_ext coset")

    # vk digest (identical bytes to the JAX package's)
    h = hashlib.blake2b(digest_size=64, person=b"WH2-TPU-vk")
    h.update(k.to_bytes(4, "little"))
    h.update(domain.extended_k.to_bytes(4, "little"))
    h.update(repr(
        (cs.num_fixed, cs.num_advice, cs.num_instance,
         [(nm, str(g)) for nm, g in cs.gates],
         [(lk.name, [str(e) for e in lk.inputs], [str(e) for e in lk.tables])
          for lk in cs.lookups],
         cs.perm_columns)
    ).encode())
    for c in fixed_comms + perm_comms:
        h.update(compress_g1(c))
    repr_int = int.from_bytes(h.digest(), "little") % R

    vk = VerifyingKey(domain, cs, fixed_comms, perm_comms, repr_int)
    fence(dev)  # the key's tensors are finished when it returns
    return ProvingKey(vk, srs, dev, fixed_lagrange, fixed_coeff, fixed_ext,
                      sigma_lagrange, sigma_coeff, sigma_ext, l0_ext,
                      llast_ext, lblind_ext, x_ext, omega_mont, spans)
