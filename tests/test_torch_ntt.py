"""The port's NTT against the JAX package's fused Pallas NTT (CPU).

The JAX side runs `ntt_fused(..., t_lanes=16)` in interpret mode, so its
cross-block stage B runs, as tests/test_ntt_pallas.py runs it. The port's
blocked schedule (stage A at T = 16, then stage B per stage) runs through
the kernels' plain versions and is held against the stage loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webauthn_halo2_tpu.fields.limbs import FR_SPEC as J_FR
from webauthn_halo2_tpu.ops import ntt as JN
from webauthn_halo2_tpu.ops import ntt_pallas as JNP
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
from webauthn_halo2_tpu_torch.ops import ntt as N
from webauthn_halo2_tpu_torch.plonk.domain import Domain

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)


def _ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(r)) % J_FR.p for r in words]


@pytest.mark.parametrize("k", [6, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_fused_interpret(k, inverse):
    vals = _ints(k, 1 << k)
    want = J_FR.decode(np.asarray(JNP.ntt_fused(
        J_FR, jnp.asarray(J_FR.encode(vals)), k, inverse, 16)))
    a = torch.as_tensor(FR_SPEC.encode(vals))
    got = (N.intt if inverse else N.ntt)(FR_SPEC, a, k)
    assert FR_SPEC.decode(got.numpy()) == want


@pytest.mark.parametrize("k", [6, 8])
def test_blocked_schedule_matches_stage_loop(k):
    """Stage A at T = 16 and stage B per remaining stage (plain versions of
    csrc/ntt.cu) against `_ntt_core`, batched."""
    x = torch.stack([torch.as_tensor(FR_SPEC.encode(_ints(k + s, 1 << k)))
                     for s in range(3)], dim=1)
    for inverse in (False, True):
        assert torch.equal(N.ntt_fused(FR_SPEC, x, k, inverse, 16),
                           N._ntt_core(FR_SPEC, x, k, inverse))
        assert torch.equal(N.ntt_fused(FR_SPEC, x, k, inverse, 4),
                           N._ntt_core(FR_SPEC, x, k, inverse))
    assert torch.equal(N.intt(FR_SPEC, N.ntt(FR_SPEC, x, k), k), x)


def test_ntt_is_the_dft():
    k = 4
    vals = _ints(99, 1 << k)
    w = N.root_of_unity(k)
    want = [sum(v * pow(w, i * j, FR_SPEC.p) for j, v in enumerate(vals)) % FR_SPEC.p
            for i in range(1 << k)]
    assert FR_SPEC.decode(N.ntt(FR_SPEC, torch.as_tensor(FR_SPEC.encode(vals)), k).numpy()) == want


def test_twiddles_match_jax_stage_twiddles():
    k = 8
    jt = JN._stage_twiddles(k, True, J_FR.p, JN._base_root(J_FR))
    for s, tw in enumerate(N._stage_twiddles(k, True)):
        assert FR_SPEC.decode(tw) == J_FR.decode(np.asarray(jt[s], np.int32))


def test_coset_extension_matches_jax():
    from webauthn_halo2_tpu.plonk.domain import Domain as JDomain

    k, ek = 5, 7
    vals = _ints(7, 1 << k)
    want = J_FR.decode(np.asarray(JDomain(k, ek).coeff_to_extended(
        jnp.asarray(J_FR.encode(vals)))))
    got = Domain(k, ek).coeff_to_extended(torch.as_tensor(FR_SPEC.encode(vals)))
    assert FR_SPEC.decode(got.numpy()) == want
    back = Domain(k, ek).extended_to_coeff(got)[:, :1 << k]
    assert FR_SPEC.decode(back.numpy()) == vals


def test_stage_wrappers_on_cpu_take_the_plain_versions():
    k = 5
    x = torch.as_tensor(FR_SPEC.encode(_ints(3, 1 << k)))[:, None, :]
    tw = N._twiddles_dev(k, False, "cpu")
    before = dict(N.LAUNCHES)
    assert torch.equal(N.stage_a(FR_SPEC, x, tw, 3), N.stage_a_plain(FR_SPEC, x, tw, 3))
    assert torch.equal(N.stage_b(FR_SPEC, x, tw, 3), N.stage_b_plain(FR_SPEC, x, tw, 3))
    assert N.LAUNCHES == before
