"""The port's fused EC add (ops/ec.add_unsafe_fast, csrc/ec.cu) against the
JAX package (CPU).

On a CPU tensor `add_unsafe_fast` takes `add_unsafe`, its plain version; the
kernel runs only on the card, where chip_smoke.py holds it against that
plain version word for word. Here the plain path is held against the JAX
package's `ec.add_unsafe` (XLA on the CPU, the reference that
tests/test_pallas.py holds the Pallas kernel against) and the host curve,
on SRS points with infinities on either side and on both, exactly, at the
batch shapes the serial Pippenger passes.
"""
import numpy as np
import pytest
import torch

from test_torch_msm import _inputs
from webauthn_halo2_tpu_torch import convert
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE
from webauthn_halo2_tpu_torch.ops import ec as E

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

CURVE = E.BN254_CURVE
G = BN254_G1_CURVE


def _operands(n: int, seed: int):
    """n pairs of distinct SRS points, about a quarter infinite on each side."""
    g, _ = _inputs((2 * n - 1).bit_length())
    ps = E.to_affine_ints(CURVE, convert.point_from_jax(*g, device="cpu"))
    rng = np.random.default_rng(seed)
    a = [None if rng.random() < 0.25 else ps[i] for i in range(n)]
    b = [None if rng.random() < 0.25 else ps[n + i] for i in range(n)]
    a[0], b[1], a[2], b[2] = None, None, None, None
    return a, b


def test_add_unsafe_fast_matches_jax_add_unsafe():
    from webauthn_halo2_tpu.ops import ec as JE

    a, b = _operands(32, 8)
    got = E.to_affine_ints(CURVE, E.add_unsafe_fast(
        CURVE, E.from_affine_ints(CURVE, a), E.from_affine_ints(CURVE, b)))
    want = JE.to_affine_ints(JE.BN254_CURVE, JE.add_unsafe(
        JE.BN254_CURVE, JE.from_affine_ints(JE.BN254_CURVE, a),
        JE.from_affine_ints(JE.BN254_CURVE, b)))
    assert got == want == [G.add(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("shape", [(4, 8), (2, 16)], ids=["grow (R, K)", "scan (R, 2K)"])
def test_add_unsafe_fast_takes_the_serial_pippengers_shapes(shape):
    """(8, R, K) from the run growth, (8, R, 2K) from the boundary scan: the
    same words as `add_unsafe` on the flattened batch."""
    a, b = _operands(32, 9)
    P, Q = (E.JPoint(*(c.reshape((8,) + shape) for c in E.from_affine_ints(CURVE, pts)))
            for pts in (a, b))
    got = E.add_unsafe_fast(CURVE, P, Q)
    flat = E.add_unsafe(CURVE, *(E.JPoint(*(c.reshape(8, -1) for c in pt)) for pt in (P, Q)))
    assert all(torch.equal(x.reshape(8, -1), y) for x, y in zip(got, flat))
    assert got.x.shape == (8,) + shape


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    a, b = _operands(8, 10)
    P, Q = E.from_affine_ints(CURVE, a), E.from_affine_ints(CURVE, b)
    # the counter is the process's: a test file run earlier in this worker
    # (tests/test_torch_devices.py, on its fake cards) may have raised it
    E.LAUNCHES["ec_add_unsafe"] = 0
    with pytest.raises(ValueError, match="CUDA"):
        E.add_unsafe_cuda(CURVE, P, Q)
    E.add_unsafe_fast(CURVE, P, Q)
    assert E.LAUNCHES == {"ec_add_unsafe": 0}
