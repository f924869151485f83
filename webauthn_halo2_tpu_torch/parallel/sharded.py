"""Proving over the ranks of a torch.distributed group: sharded MSM, the
transpose NTT, batch commits, and the two prover hooks.

The port of the JAX package's parallel/sharded.py. There one controller
drives a mesh of chips; here each of D ranks runs the whole prover on the
same inputs (and the same `rng`), and the collectives live only inside
the primitives below. Each primitive takes the full input that every rank
holds and returns the full result on every rank, equal to one device's,
so every rank ends with the same proof bytes.

  * `sharded_msm`: rank r runs the MSM engine (the caller's, else
    `keygen.MSM_ENGINE`) on its contiguous block of n/D points; the D partial sums, gathered as Jacobian words,
    are joined by a tree of complete adds.
  * `sharded_ntt` / `sharded_intt`: the four-step transpose FFT. With
    i = i1 n2 + i2 (n2 = n/D) rank r holds row i1 = r; an all-to-all
    hands it every row's r-th block of i2; a D-point DFT over i1 and the
    cross twiddle w^(i2 j1) follow; a second all-to-all hands rank j1
    the whole i2 range of its j1; a local length-n2 transform gives
    X[j1 + D j2]; an all-gather interleaves the D results. n % D^2 == 0.
  * `sharded_coeff_to_extended`: zero-pad, coset shift, `sharded_ntt`.
  * `batch_commit`: B columns split over the ranks, each block through
    the engine's `msm_batch`, the points gathered in column order.

The hooks, read at each call as in the JAX package, under one opt-in,
WH2_SHARDED=1 (the JAX package's WH2_SHARDED_COMMITS and WH2_SHARDED_NTT
together), and only in a default group of two or more ranks, all of which
prove the same inputs: `keygen.commit_lagrange_batch` goes through
`sharded_msm` (the coefficient commits stay on one device), and
`fused.batched_l2c` and `batched_c2e` through the transpose NTT where
n % D^2 == 0. Under WH2_TRACE, `ROUTES` counts which way each call went
and `COLLECTIVES` the calls, bytes received and seconds of the
collectives (their stream fenced on either side).

Backends: NCCL takes one rank a card (`make_mesh` refuses two ranks on
one card before NCCL would). gloo serves the CPU and several ranks
sharing a card. Either takes the tensors where they lie: gloo copies a
card's tensors through host memory itself (all_to_all_single and
all_gather on CUDA tensors, torch 2.11).
"""
from __future__ import annotations

import functools
import os
import socket
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import cached, fence, tracing
from ..fields.constants import BN254_FR, BN254_FR_GENERATOR
from ..fields.limbs import FR_SPEC, W
from ..ops import ec as E
from ..ops import modops as M
from ..ops import ntt as N

ROUTES = {"commits_sharded": 0, "commits_one_device": 0,
          "l2c_sharded": 0, "l2c_one_device": 0,
          "c2e_sharded": 0, "c2e_one_device": 0}
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}


@dataclass(frozen=True)
class Mesh:
    """A process group as the primitives see it: this rank, the group's
    size, the device its tensors live on and the group's backend."""
    group: object  # a ProcessGroup; None is the default group
    rank: int
    size: int
    device: torch.device
    backend: str


_MESHES: dict = {}


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialised process group (None: the default group),
    on `device`: None means cuda:(rank % cards) and raises without a card;
    only an explicit "cpu" runs on the CPU. Every rank calls it."""
    if not _initialised():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    pg = group if group is not None else dist.group.WORLD
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    key = (pg, str(dev))
    mesh = _MESHES.get(key)
    if mesh is None:
        backend = str(dist.get_backend(group))
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: the sharded primitives take gloo or nccl")
        if backend == "nccl":
            _one_rank_per_card(group, dev)
        mesh = _MESHES[key] = Mesh(group, rank, size, dev, backend)
    return mesh


def _card_id(dev: torch.device) -> str:
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"


def _one_rank_per_card(group, dev: torch.device) -> None:
    """NCCL refuses two ranks on one card: find that first, over a gloo
    group of the same ranks, and raise with the ranks that share one."""
    if dev.type != "cuda":
        raise ValueError(f"NCCL takes CUDA tensors, not {dev}: use gloo on the CPU")
    ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
    side = dist.new_group(ranks=ranks, backend="gloo")
    ids = [None] * len(ranks)
    try:
        dist.all_gather_object(ids, _card_id(dev), group=side)
    finally:
        dist.destroy_process_group(side)
    shared = {i: [r for r, j in enumerate(ids) if j == i] for i in ids}
    shared = {i: rs for i, rs in shared.items() if len(rs) > 1}
    if shared:
        raise RuntimeError(
            "NCCL takes one rank a card, but ranks "
            + "; ".join(f"{rs} share {i}" for i, rs in shared.items())
            + ": give each rank its own card, or use the gloo backend")


# --- the hooks ------------------------------------------------------------

def _ranks() -> int:
    return dist.get_world_size() if _initialised() else 1


def _route(name: str, mesh: Mesh | None) -> Mesh | None:
    if tracing():
        ROUTES[f"{name}_{'one_device' if mesh is None else 'sharded'}"] += 1
    return mesh


def _sharded() -> bool:
    return os.environ.get("WH2_SHARDED", "0") == "1" and _ranks() >= 2


def commit_mesh(device) -> Mesh | None:
    """The mesh the Lagrange commits go over: WH2_SHARDED=1 and a default
    group of two or more ranks; else None (one device)."""
    return _route("commits", make_mesh(device=device) if _sharded() else None)


def ntt_mesh(what: str, k: int, device) -> Mesh | None:
    """The mesh of a basis conversion of size 2^k ("l2c" or "c2e"):
    WH2_SHARDED=1, two or more ranks and 2^k % D^2 == 0; else None."""
    on = _sharded() and (1 << k) % (_ranks() ** 2) == 0
    return _route(what, make_mesh(device=device) if on else None)


# --- collectives ------------------------------------------------------------

def _collective(mesh: Mesh, x: torch.Tensor, run) -> torch.Tensor:
    """run(x contiguous) -> the received tensor; counted in COLLECTIVES
    under WH2_TRACE."""
    timed = tracing()
    if timed:
        fence(mesh.device)
        t0 = time.perf_counter()
    out = run(x.contiguous())
    if timed:
        fence(mesh.device)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += out.numel() * out.element_size()
        COLLECTIVES["seconds"] += time.perf_counter() - t0
    return out


def _all_to_all(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """send (D, ...): send[s] goes to rank s. Returns (D, ...) with
    out[s] = what rank s sent here."""
    def run(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.group)
        return out
    return _collective(mesh, send, run)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(D, *t.shape): every rank's t, in rank order."""
    def run(x):
        out = x.new_empty((mesh.size,) + tuple(x.shape))
        dist.all_gather(list(out.unbind(0)), x, group=mesh.group)
        return out
    return _collective(mesh, t, run)


# --- distributed MSM ----------------------------------------------------------

def _tree_reduce_complete(pts: E.JPoint) -> E.JPoint:
    """Sum (8, D, *batch) points over axis 1 with complete adds, halves
    first, an odd leftover kept at the end (the JAX package's order)."""
    n = pts.x.shape[1]
    while n > 1:
        half = n // 2
        s = E.add(E.BN254_CURVE, E.JPoint(*(t[:, :half] for t in pts)),
                  E.JPoint(*(t[:, half:2 * half] for t in pts)))
        if n % 2:
            s = E.JPoint(*(torch.cat([a, t[:, -1:]], dim=1) for a, t in zip(s, pts)))
            n = half + 1
        else:
            n = half
        pts = s
    return E.JPoint(*(t[:, 0] for t in pts))


def _gather_points(mesh: Mesh, pts: list) -> torch.Tensor:
    """B host affine points on each rank -> (D, 3, 8, B) Jacobian words."""
    words = torch.stack(list(E.from_affine_ints(E.BN254_CURVE, pts, device=mesh.device)))
    return _all_gather(mesh, words)


def _engine(engine):
    """The MSM engine a rank runs its block on: `engine`, or else
    `keygen.MSM_ENGINE` (the v3 pipeline unless a caller assigned another)."""
    if engine is not None:
        return engine
    from ..plonk import keygen as KG

    return KG.MSM_ENGINE


def sharded_msm_batch(mesh: Mesh, points: E.JPoint, scalars_batch: torch.Tensor,
                      c: int | None = None, engine=None) -> list:
    """B MSMs over one base set, the point axis split over the ranks:
    scalars (8, B, n) Montgomery Fr -> B host affine points (None for
    infinity), on every rank."""
    n = scalars_batch.shape[-1]
    if n % mesh.size:
        raise ValueError(f"sharded_msm: {n} points do not split over {mesh.size} ranks")
    lo, hi = mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size
    block = E.JPoint(*(t[:, lo:hi].contiguous() for t in points))
    part = _engine(engine).msm_batch(E.BN254_CURVE, block,
                                     scalars_batch[:, :, lo:hi].contiguous(), c)
    words = _gather_points(mesh, part)  # (D, 3, 8, B)
    sums = _tree_reduce_complete(E.JPoint(
        *(words[:, i].permute(1, 0, 2).contiguous() for i in range(3))))
    return E.to_affine_ints(E.BN254_CURVE, sums)


def sharded_msm(mesh: Mesh, points: E.JPoint, scalars_mont: torch.Tensor,
                c: int | None = None, engine=None):
    """One MSM, scalars (8, n) Montgomery Fr -> host affine point."""
    return sharded_msm_batch(mesh, points, scalars_mont[:, None, :], c, engine)[0]


# --- distributed NTT ----------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _ntt_shard_consts(k: int, D: int, rank: int, inverse: bool):
    """(dft (8, D, D) [j1, i1] = w_D^(i1 j1), twiddles (8, D, n2/D) [j1, m]
    = s w^(i2 j1) for this rank's block of i2 = rank n2/D + m), Montgomery
    words. The inverse takes w^-1 and s = D^-1; the local inverse transform
    of length n2 supplies the rest of n^-1."""
    p = BN254_FR
    n2 = (1 << k) // D
    n2d = n2 // D
    w = N.root_of_unity(k)
    if inverse:
        w = pow(w, p - 2, p)
    wD = pow(w, n2, p)
    dft = [pow(wD, i1 * j1 % D, p) for j1 in range(D) for i1 in range(D)]
    scale = pow(D, p - 2, p) if inverse else 1
    tw = []
    for j1 in range(D):
        step = pow(w, j1, p)
        acc = scale * pow(step, rank * n2d, p) % p
        for _ in range(n2d):
            tw.append(acc)
            acc = acc * step % p
    return (FR_SPEC.encode(dft).reshape(W, D, D),
            np.ascontiguousarray(FR_SPEC.encode(tw).reshape(W, D, n2d)))


def sharded_ntt(mesh: Mesh, a: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """NTT of size 2^k over the ranks, (8, n) or (8, B, n), equal to
    `ntt.ntt` (or `ntt.intt`) on one device; all B columns share each
    collective."""
    x, squeeze = N._as_stack(a)
    D, r = mesh.size, mesh.rank
    n = 1 << k
    if x.shape[2] != n:
        raise ValueError(f"sharded_ntt: length {x.shape[2]} is not 2^{k}")
    if n % (D * D) or D & (D - 1):
        raise ValueError(f"sharded_ntt: {D} ranks need a power of two D with "
                         f"n % D^2 == 0 (n = {n})")
    B, n2, n2d = x.shape[1], n // D, n // (D * D)
    dft = cached(("shard_dft", k, D, inverse),
                 lambda: _ntt_shard_consts(k, D, r, inverse)[0], x.device)
    tw = cached(("shard_tw", k, D, r, inverse),
                lambda: _ntt_shard_consts(k, D, r, inverse)[1], x.device)
    # 1. row i1 = r, cut into D blocks of i2: block c goes to rank c
    row = x[:, :, r * n2:(r + 1) * n2].reshape(W, B, D, n2d).permute(2, 0, 1, 3)
    recv = _all_to_all(mesh, row)  # (D [i1], 8, B, n2d): block r of every row
    # 2. the D-point DFT over i1, then the cross twiddle
    ys = []
    for j1 in range(D):
        acc = M.montmul(FR_SPEC, recv[0], dft[:, j1, 0, None, None])
        for i1 in range(1, D):
            acc = M.add(FR_SPEC, acc, M.montmul(FR_SPEC, recv[i1], dft[:, j1, i1, None, None]))
        ys.append(M.montmul(FR_SPEC, acc, tw[:, j1, None, :]))
    # 3. j1 goes to rank j1, which gets block s of i2 from rank s
    back = _all_to_all(mesh, torch.stack(ys))  # (D [block], 8, B, n2d)
    # 4. the length-n2 transform over i2: z[j2] = X[r + D j2]
    z_in = back.permute(1, 2, 0, 3).reshape(W, B, n2)
    k2 = k - (D.bit_length() - 1)
    z = (N.intt if inverse else N.ntt)(FR_SPEC, z_in, k2)
    # 5. every rank's z, interleaved: X[j1 + D j2]
    out = _all_gather(mesh, z).permute(1, 2, 3, 0).reshape(W, B, n)
    return out[:, 0] if squeeze else out


def sharded_intt(mesh: Mesh, a: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse NTT over the ranks, equal to `ntt.intt`."""
    return sharded_ntt(mesh, a, k, inverse=True)


def sharded_coeff_to_extended(mesh: Mesh, a: torch.Tensor, k: int,
                              ext_k: int) -> torch.Tensor:
    """`Domain(k, ext_k).coeff_to_extended` with its NTT over the ranks:
    (8, [B,] 2^k) coefficients -> evaluations on the coset g H_ext."""
    if a.shape[-1] != 1 << k or ext_k < k:
        raise ValueError(f"sharded_coeff_to_extended: length {a.shape[-1]}, k={k}, "
                         f"ext_k={ext_k}")
    pad = torch.zeros(a.shape[:-1] + ((1 << ext_k) - a.shape[-1],),
                      dtype=a.dtype, device=a.device)
    shifted = N.coset_shift(FR_SPEC, torch.cat([a, pad], dim=-1), BN254_FR_GENERATOR)
    return sharded_ntt(mesh, shifted, ext_k)


# --- batch commits ------------------------------------------------------------

def batch_commit(mesh: Mesh, g_lag: E.JPoint, columns_mont: torch.Tensor,
                 engine=None) -> list:
    """Commit B columns (8, B, n), the columns split over the ranks: B
    host affine points in column order, on every rank."""
    B = columns_mont.shape[1]
    if B % mesh.size:
        raise ValueError(f"batch_commit: {B} columns do not split over {mesh.size} ranks")
    lo, hi = mesh.rank * B // mesh.size, (mesh.rank + 1) * B // mesh.size
    part = _engine(engine).msm_batch(E.BN254_CURVE, g_lag,
                                     columns_mont[:, lo:hi].contiguous())
    words = _gather_points(mesh, part)  # (D, 3, 8, B/D)
    cols = words.permute(1, 2, 0, 3).reshape(3, W, B)
    return E.to_affine_ints(E.BN254_CURVE, E.JPoint(*cols))
