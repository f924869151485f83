"""Serial Pippenger multi-scalar multiplication over bn254 G1 (KZG commits).

The port of the JAX package's serial MSM (ops/msm.py), the engine that its
prover runs with WH2_MSM_IMPL=xla, as torch ops whose every field multiply
goes through `modops.montmul` (the montmul kernel on the card) and whose
every point add of steps 3-4 is `ec.add_unsafe_fast` (the fused add of
csrc/ec.cu on the card, as WH2_PALLAS=1 makes it in the JAX package):

  1. scalars -> canonical words -> c-bit window digits;
  2. per window: sort the digits, gather the points in that order;
  3. K-lane serial run accumulation: the sorted stream is cut into K
     contiguous chunks of S = n/K steps; each step adds the lane's point
     into a running per-run accumulator and scatters finished runs into the
     bucket array (collision-free: an interior run lies inside one lane);
  4. runs that cross lane boundaries are merged by a segmented
     Hillis-Steele scan over the 2K boundary slots;
  5. suffix sums over the buckets, then their total, give sum_b b * B_b;
  6. the Horner combine of the window sums (c doublings per window).

The JAX `lax.scan` over windows is a batch axis here: every window of
every MSM of a batch runs in the same tensor ops, rows R = W * B. Step 6
runs on the host with Python ints (as the JAX package's v3 path does),
since it is a chain of W * c doublings on a handful of points.

PRECONDITION (as in the JAX package): points pairwise distinct, as SRS
bases are; steps 3-4 use unsafe adds. Step 5 uses complete adds.

The prover commits through the v3 pipeline of ops/msm_fused.py; this
serial engine is its plain reference, and commits take it when
plonk/keygen.MSM_ENGINE is set to this module. `CALLS` counts the bucket
sums it runs, so a run can show which route it took.
"""
from __future__ import annotations

import torch

from ..fields.limbs import FR_SPEC, W
from ..fields.ref_curve import BN254_G1_CURVE
from . import ec as E
from . import modops as M
from .ec import CurveSpec, JPoint

DEFAULT_C = 13
SCALAR_BITS = 32 * W

CALLS = {"window_bucket_sum": 0}


def _default_c(n: int) -> int:
    """Window size balancing W * (n + 2^(c+1)) total work."""
    return min(DEFAULT_C, max(4, n.bit_length() - 5))


def _default_lanes(n: int) -> int:
    lanes = max(64, min(4096, n // 64))
    while n % lanes or lanes > n:
        lanes //= 2
    return lanes


def scalar_digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(8, *batch) canonical words -> (Wn, *batch) int64 c-bit digits."""
    u = M._u64(scalars_std)
    nwin = -(-SCALAR_BITS // c)
    digits = []
    for w in range(nwin):
        bit0 = w * c
        word, shift = divmod(bit0, 32)
        v = u[word] >> shift
        if shift + c > 32 and word + 1 < W:
            v = v | (u[word + 1] << (32 - shift))
        digits.append(v & ((1 << c) - 1))
    return torch.stack(digits)


def _pt_cols(p: JPoint, idx) -> JPoint:
    return JPoint(p.x[..., idx], p.y[..., idx], p.z[..., idx])


def _roll(p: JPoint, d: int) -> JPoint:
    return JPoint(*(torch.roll(c, d, dims=-1) for c in p))


def _prefix_scan_points(curve: CurveSpec, pts: JPoint, seg: torch.Tensor,
                        complete: bool = False) -> JPoint:
    """Segmented inclusive prefix sum along the last axis (Hillis-Steele
    log passes). seg: (*rows, m) segment ids on contiguous runs; the last
    element of each segment ends up holding the segment total."""
    m = seg.shape[-1]
    pos = torch.arange(m, device=seg.device)
    add = E.add if complete else E.add_unsafe_fast
    d = 1
    while d < m:
        cand = add(curve, _roll(pts, d), pts)
        ok = (seg == torch.roll(seg, d, dims=-1)) & (pos >= d)
        pts = E.point_select(ok, cand, pts)
        d *= 2
    return pts


def _suffix_sum_points(curve: CurveSpec, pts: JPoint) -> JPoint:
    """Unsegmented suffix sums along the last axis: out[i] = sum_{j>=i}."""
    m = pts.x.shape[-1]
    pos = torch.arange(m, device=pts.x.device)
    d = 1
    while d < m:
        # suffix partials repeat across empty buckets: complete add needed
        cand = E.add(curve, pts, _roll(pts, -d))
        pts = E.point_select(pos < m - d, cand, pts)
        d *= 2
    return pts


def _sum_points(curve: CurveSpec, pts: JPoint) -> JPoint:
    """Total along the last axis by halving passes of complete adds."""
    while pts.x.shape[-1] > 1:
        m = pts.x.shape[-1]
        if m % 2:
            inf = E.infinity(pts.x.shape[1:-1] + (1,), curve, pts.x.device)
            pts = JPoint(*(torch.cat([c, i], dim=-1) for c, i in zip(pts, inf)))
            m += 1
        h = m // 2
        pts = E.add(curve, _pt_cols(pts, slice(0, h)), _pt_cols(pts, slice(h, m)))
    return _pt_cols(pts, 0)


def _scatter_(buckets: JPoint, target: torch.Tensor, vals: JPoint) -> None:
    """In place: the bucket tensors belong to one `_window_bucket_sum`."""
    idx = target.unsqueeze(0).expand(vals.x.shape)
    for b, v in zip(buckets, vals):
        b.scatter_(-1, idx, v)


def _lane_runs(curve: CurveSpec, step, S: int, nb: int, grow):
    """Step 3, the K-lane run accumulation, shared by both engines.

    Lane k walks sorted positions [k S, (k + 1) S); `step(t)` gives the
    digits (R, K) and points (8, R, K) at step t of every lane, and
    `grow(acc, pt)` adds a point into a run. Returns (buckets (8, R, nb + 1)
    holding the closed interior runs, slot nb a dump; the boundary
    fragments [A_0, B_0, A_1, B_1, ...] (8, R, 2K); their digits (R, 2K))."""
    acc = cur = first_sum = first_dig = has_first = buckets = None
    for t in range(S):
        d, pt = step(t)
        if t == 0:
            R, K = d.shape
            dev = d.device
            buckets = E.infinity((R, nb + 1), curve, dev)
            buckets = JPoint(*(b.contiguous() for b in buckets))
            acc, cur = pt, d
            first_sum = E.infinity((R, K), curve, dev)
            first_dig = torch.zeros_like(d)
            has_first = torch.zeros(d.shape, dtype=torch.bool, device=dev)
            continue
        new_run = d != cur
        emit_first = new_run & ~has_first
        emit_scatter = new_run & has_first
        first_sum = E.point_select(emit_first, acc, first_sum)
        first_dig = torch.where(emit_first, cur, first_dig)
        has_first = has_first | new_run
        # interior runs: distinct lanes always carry distinct digits here
        _scatter_(buckets, torch.where(emit_scatter, cur, nb), acc)
        grown = grow(acc, pt)
        acc = E.point_select(new_run, pt, grown)
        cur = d

    # boundary slots [A_0, B_0, A_1, B_1, ...]: A_l = the lane's first run
    # (an infinity merged into B's segment when the lane has one run),
    # B_l = the lane's final accumulator
    a_dig = torch.where(has_first, first_dig, cur)
    a_pts = E.point_select(has_first, first_sum, E.infinity((R, K), curve, dev))
    seg = torch.stack([a_dig, cur], dim=-1).reshape(R, 2 * K)
    bnd = JPoint(*(torch.stack([a, b], dim=-1).reshape(W, R, 2 * K)
                   for a, b in zip(a_pts, acc)))
    return buckets, bnd, seg


def _tail_mask(seg: torch.Tensor) -> torch.Tensor:
    """(R, m) segment ids -> True at the last fragment of each segment."""
    last = torch.ones(seg.shape[:-1] + (1,), dtype=torch.bool, device=seg.device)
    return torch.cat([seg[:, :-1] != seg[:, 1:], last], dim=1)


def _window_bucket_sum(curve: CurveSpec, spts: JPoint, sdig: torch.Tensor,
                       c: int, lanes: int) -> JPoint:
    """sum_b b * (sum of points with digit b) for each row.

    spts (8, R, n) / sdig (R, n) are sorted by digit along n; n % lanes == 0.
    Returns a JPoint of (8, R)."""
    CALLS["window_bucket_sum"] += 1
    R, n = sdig.shape
    K = lanes
    S = n // K
    nb = 1 << c
    dev = sdig.device
    sdig2 = sdig.reshape(R, K, S)
    px, py, pz = (t.reshape(W, R, K, S) for t in spts)

    def step(t):
        return sdig2[:, :, t], JPoint(px[..., t], py[..., t], pz[..., t])

    buckets, bnd, seg = _lane_runs(
        curve, step, S, nb, lambda acc, pt: E.add_unsafe_fast(curve, acc, pt))
    merged = _prefix_scan_points(curve, bnd, seg)
    _scatter_(buckets, torch.where(_tail_mask(seg), seg, nb), merged)

    # drop the dump slot, zero bucket 0, then suffix sums and their total
    buckets = _pt_cols(buckets, slice(0, nb))
    inf1 = E.infinity((R, 1), curve, dev)
    buckets = JPoint(*(torch.cat([i, b[..., 1:]], dim=-1)
                       for i, b in zip(inf1, buckets)))
    sfx = _suffix_sum_points(curve, buckets)
    return _sum_points(curve, _pt_cols(sfx, slice(1, nb)))


def _msm_impl(curve: CurveSpec, points: JPoint, scalars_mont: torch.Tensor,
              c: int | None = None, lanes: int | None = None) -> JPoint:
    """Window sums of B MSMs sharing one base set.

    points: (8, n) affine Jacobian words; scalars_mont: (8, B, n) Montgomery
    Fr. Returns a JPoint of (8, Wn, B): window w of MSM b."""
    _, B, n = scalars_mont.shape
    c = c if c is not None else _default_c(n)
    lanes = lanes if lanes is not None else _default_lanes(n)
    std = M.normalize(FR_SPEC, M.from_mont(FR_SPEC, scalars_mont))
    digits = scalar_digits(std, c)  # (Wn, B, n)
    nwin = digits.shape[0]
    sdig, order = torch.sort(digits.reshape(nwin * B, n), dim=-1, stable=True)
    spts = _pt_cols(points, order)  # (8, Wn*B, n)
    wsums = _window_bucket_sum(curve, spts, sdig, c, lanes)
    return JPoint(*(t.reshape(W, nwin, B) for t in wsums))


def _host_horner(curve: CurveSpec, wsums: JPoint, c: int) -> list:
    """Window sums (8, Wn, B) -> B host affine points: sum_w 2^(c w) S_w."""
    nwin, B = wsums.x.shape[1:]
    aff = E.to_affine_ints(curve, wsums)  # row-major (w, b)
    G = BN254_G1_CURVE
    out = []
    for b in range(B):
        acc = aff[(nwin - 1) * B + b]
        for w in range(nwin - 2, -1, -1):
            acc = G.add(G.mul(1 << c, acc), aff[w * B + b])
        out.append(acc)
    return out


def msm_batch(curve: CurveSpec, points: JPoint, scalars_batch: torch.Tensor,
              c: int | None = None, lanes: int | None = None) -> list:
    """B MSMs sharing one base set: scalars (8, B, n) Montgomery Fr ->
    B host affine points (None for infinity)."""
    n = scalars_batch.shape[-1]
    c = c if c is not None else _default_c(n)
    wsums = _msm_impl(curve, points, scalars_batch, c, lanes)
    return _host_horner(curve, wsums, c)


def msm(curve: CurveSpec, points: JPoint, scalars_mont: torch.Tensor,
        c: int | None = None, lanes: int | None = None):
    """One MSM: scalars (8, n) Montgomery Fr -> host affine point."""
    return msm_batch(curve, points, scalars_mont[:, None, :], c, lanes)[0]

