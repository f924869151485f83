"""The v1 Pippenger commit driver over bn254 G1.

The port of the JAX package's `msm_pallas_batch` and `_msm_pallas_single`
(ops/msm_pallas.py), the route its prover commits through when
WH2_MSM_V3=0. Step by step, as the JAX driver does it, and where it
differs from the v3 pipeline of ops/msm_fused.py:

  * MSMs run one at a time, Wn = 20 rows each at c = 13 (the JAX host loop
    over the batch);
  * per row, the digits sorted with their point indices: the same
    (digit, index) order as v3's packed key, so `msm_fused.sorted_stream`;
  * the interior: the JAX v1 kernel `_interior` computes the function of
    v3's `_interior_v2` on unpacked limbs; on the port's 8-word layout the
    two are one function, so `msm_fused.interior` (csrc/msm.cu
    `msm_interior_kernel`) serves both;
  * the boundary merge is the plain segmented Hillis-Steele scan
    (`msm._prefix_scan_points`, XLA in the JAX package, not the scan
    kernel), whose adds are `ec.add_unsafe_fast`: the fused EC add of
    csrc/ec.cu on the card;
  * the tail scatter and the combine kernel as in v3; then the Horner fold
    of the window sums on the device (Wn - 1 steps of c doublings and an
    `add_unsafe` of the next window sum, the JAX fori_loop), and one
    conversion of the batch's points to host affine ints.

`keygen.MSM_ENGINE = msm_v1` commits through it. The commitments equal
the v3 and serial routes', so a proof is byte-identical on all three.

PRECONDITION (as in the JAX package): affine (Z = one), pairwise distinct
base points, as SRS bases are.
"""
from __future__ import annotations

import torch

from ..fields.limbs import FR_SPEC
from . import ec as E
from . import modops as M
from . import msm as MS
from . import msm_fused as MF
from .ec import CurveSpec, JPoint


def window_sums(curve: CurveSpec, points: JPoint, scalars_mont: torch.Tensor,
                c: int, lanes: int) -> JPoint:
    """One MSM: points (8, n) affine, scalars (8, n) Montgomery Fr -> its
    window sums, a JPoint of (8, Wn)."""
    std = M.normalize(FR_SPEC, M.from_mont(FR_SPEC, scalars_mont))
    digits = MS.scalar_digits(std, c)  # (Wn, n)
    sdig, order = MF.sorted_stream(digits, lanes)
    buckets, bnd, seg = MF.interior(curve, points.x, points.y, sdig, order, 1 << c)
    merged = MS._prefix_scan_points(curve, bnd, seg)
    MF.scatter_tails(buckets, merged, seg)
    return MF.combine(curve, buckets)


def horner(curve: CurveSpec, wsums: JPoint, c: int) -> JPoint:
    """sum_w 2^(c w) S_w on the device: (8, Wn) window sums -> (8, 1)."""
    nwin = wsums.x.shape[-1]
    acc = JPoint(*(t[:, nwin - 1:] for t in wsums))
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = E.double(curve, acc)
        acc = E.add_unsafe(curve, acc, JPoint(*(t[:, w:w + 1] for t in wsums)))
    return acc


def msm_batch(curve: CurveSpec, points: JPoint, scalars_batch: torch.Tensor,
              c: int | None = None) -> list:
    """B MSMs sharing one base set, one at a time: scalars (8, B, n)
    Montgomery Fr -> B host affine points (None for infinity)."""
    n = scalars_batch.shape[-1]
    c = c if c is not None else MS._default_c(n)
    lanes = MF.lanes_for(n)
    outs = [horner(curve, window_sums(curve, points, scalars_batch[:, b], c, lanes), c)
            for b in range(scalars_batch.shape[1])]
    return E.to_affine_ints(curve, JPoint(*(torch.cat(t, dim=-1) for t in zip(*outs))))


def msm(curve: CurveSpec, points: JPoint, scalars_mont: torch.Tensor,
        c: int | None = None):
    """One MSM: scalars (8, n) Montgomery Fr -> host affine point."""
    return msm_batch(curve, points, scalars_mont[:, None, :], c)[0]
