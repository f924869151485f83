"""The port's v1 MSM driver (ops/msm_v1.py) against the JAX package (CPU).

On the CPU every kernel wrapper takes its plain version; csrc/msm.cu and
csrc/ec.cu run only on the card, where chip_smoke.py holds them against
these plain versions and proves through this engine.

  * Each MSM's window sums, folded by the host Horner, equal the JAX
    package's stored MSM outputs and the host oracle of
    tests/test_torch_msm.py, at that file's sizes.
  * The device Horner (c doublings and an unsafe add a window) equals the
    host Horner.
  * MSMs run one at a time; the boundary merge is the plain segmented scan,
    its adds `ec.add_unsafe_fast`, and the scan kernel is not used.
The JAX package's `_msm_pallas_single` takes minutes per tiny MSM in
interpret mode, so it is held here through the stored XLA MSM, which it is
bit-exact with.
"""
import functools

import pytest
import torch

from test_torch_msm import JAX_MSM, _hex, _inputs, _oracle
from webauthn_halo2_tpu_torch import convert
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G
from webauthn_halo2_tpu_torch.ops import ec as E
from webauthn_halo2_tpu_torch.ops import msm as MS
from webauthn_halo2_tpu_torch.ops import msm_fused as MF
from webauthn_halo2_tpu_torch.ops import msm_v1 as V

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

CURVE = E.BN254_CURVE


def _case(logn: int):
    g, scalars = _inputs(logn)
    pts = convert.point_from_jax(*g, device="cpu")
    sc = torch.stack([torch.as_tensor(FR_SPEC.encode(ks)) for ks in scalars], dim=1)
    n = 1 << logn
    return pts, sc, scalars, MS._default_c(n), MF.lanes_for(n)


@functools.lru_cache(maxsize=None)
def _window_sums(logn: int):
    """Each MSM's window sums, stacked (8, Wn, B), made once per process."""
    pts, sc, _, c, lanes = _case(logn)
    wsums = [V.window_sums(CURVE, pts, sc[:, b], c, lanes) for b in range(sc.shape[1])]
    return E.JPoint(*(torch.stack(t, dim=-1) for t in zip(*wsums)))


@pytest.mark.parametrize("logn", [8, 10])
def test_window_sums_match_jax_and_oracle(logn):
    _, _, scalars, c, _ = _case(logn)
    got = MS._host_horner(CURVE, _window_sums(logn), c)
    assert got == [_oracle(ks) for ks in scalars]
    assert _hex(got) == JAX_MSM[logn]


def test_device_horner_matches_host_horner():
    _, _, scalars, c, _ = _case(8)
    wsums = E.JPoint(*(t[..., 0] for t in _window_sums(8)))
    dev = E.to_affine_ints(CURVE, V.horner(CURVE, wsums, c))
    host = MS._host_horner(CURVE, E.JPoint(*(t[:, :, None] for t in wsums)), c)
    assert dev == host == [_oracle(scalars[0])]


def _g_times(k: int):
    return G.mul(k, G.g)


def test_msm_batch_runs_one_msm_at_a_time(monkeypatch):
    """Each MSM of a batch gets its own window sums (Wn rows) and its own
    device Horner; the batch's points come back in order."""
    pts, sc, _, c, lanes = _case(6)
    seen = []

    def window_sums(curve, points, scalars, c_, lanes_):
        seen.append((tuple(scalars.shape), c_, lanes_))
        k = len(seen)
        return E.from_affine_ints(CURVE, [_g_times(k)] * 4)

    def horner(curve, wsums, c_):
        return E.JPoint(*(t[:, :1] for t in wsums))

    monkeypatch.setattr(V, "window_sums", window_sums)
    monkeypatch.setattr(V, "horner", horner)
    got = V.msm_batch(CURVE, pts, sc)
    assert seen == [((8, 64), c, lanes)] * 2
    assert got == [_g_times(1), _g_times(2)]
    assert V.msm(CURVE, pts, sc[:, 0]) == _g_times(3)


def test_boundary_merge_is_the_plain_scan_of_fused_adds(monkeypatch):
    """The window sums merge the lane-boundary fragments with
    msm._prefix_scan_points, whose adds are ec.add_unsafe_fast; the scan
    kernel's wrapper is never called."""
    pts, sc, scalars, c, lanes = _case(6)
    calls = []
    fast = E.add_unsafe_fast

    def counting(curve, p, q):
        calls.append(tuple(p.x.shape))
        return fast(curve, p, q)

    def no_scan(*args):
        raise AssertionError("the v1 route does not run the scan kernel")

    monkeypatch.setattr(E, "add_unsafe_fast", counting)
    monkeypatch.setattr(MF, "scan", no_scan)
    wsums = V.window_sums(CURVE, pts, sc[:, 0], c, lanes)
    nwin = -(-256 // c)
    assert calls and set(calls) == {(8, nwin, 2 * lanes)}
    got = MS._host_horner(CURVE, E.JPoint(*(t[:, :, None] for t in wsums)), c)
    assert got == [_oracle(scalars[0])]
