"""The port's NTT against the JAX package's fused Pallas NTT (CPU).

The JAX side runs `ntt_fused(..., t_lanes=16)` in interpret mode, so its
cross-block stage B runs, as tests/test_ntt_pallas.py runs it. The port's
blocked schedule (stage A at the tile `stage_a_schedule` picks, or at
T = 16 or 4, then stage B per stage) runs through the kernels' plain
versions and is held against the stage loop. The stage-A kernel's passes
(its threads' elements and twiddles) are emulated on tensors and held
against the plain stage A.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webauthn_halo2_tpu.fields.limbs import FR_SPEC as J_FR
from webauthn_halo2_tpu.ops import ntt as JN
from webauthn_halo2_tpu.ops import ntt_pallas as JNP
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC, W
from webauthn_halo2_tpu_torch.ops import modops as M
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
    # the fused schedule the card runs: stage A at the chosen tile
    assert FR_SPEC.decode(N.ntt_fused(FR_SPEC, a, k, inverse).numpy()) == want


@pytest.mark.parametrize("k", [6, 8])
def test_blocked_schedule_matches_stage_loop(k):
    """Stage A at T = 16 and stage B per remaining stage (plain versions of
    csrc/ntt.cu) against `_ntt_core`, batched."""
    x = torch.stack([torch.as_tensor(FR_SPEC.encode(_ints(k + s, 1 << k)))
                     for s in range(3)], dim=1)
    for inverse in (False, True):
        for t_lanes in (0, 16, 4):
            assert torch.equal(N.ntt_fused(FR_SPEC, x, k, inverse, t_lanes),
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


@pytest.mark.parametrize("B, k", [(1, 17), (1, 19), (19, 17), (19, 19),
                                  (1, 6), (3, 6), (1, 8), (3, 8)])
def test_stage_a_schedule_covers_every_stage_once(B, k):
    """The proof's launch shapes and small ones: a stage-A block's passes,
    its cluster's stages, then stage B, run stages 0 .. k - 1 once each and
    in order; each pass's stages lie in its window, and a block fits the
    kernel."""
    log_t, cq = N.stage_a_schedule(B, k)
    log_b = log_t - cq
    assert 3 <= log_b <= N.T_LOG_MAX and 0 <= cq <= N.CLUSTER_LOG_MAX and log_t <= k
    passes = N.stage_a_passes(log_b)
    assert all(0 <= c <= s < e <= c + N.STAGE_A_R <= log_b for c, s, e in passes)
    stages = ([st for _, s, e in passes for st in range(s, e)] + list(range(log_b, log_t))
              + list(range(log_t, k)))
    assert stages == list(range(k))
    if k >= 17:  # the proof's launches: a block for nearly every one of the 132 SMs
        assert (B << (k - log_b)) >= 128


def _stage_a_emulated(x: torch.Tensor, tw: torch.Tensor, log_t: int, cq: int) -> torch.Tensor:
    """csrc/ntt.cu's stage-A kernel on tensors, every thread of every block
    at once: thread g's four elements of each pass, its stages, their
    twiddles, no multiply where the first pass's twiddle is 1; then the
    cluster's stages, block rank r taking half of the butterflies it shares
    with rank r ^ 2^q."""
    _, B, n = x.shape
    log_b = log_t - cq
    T, R = 1 << log_b, N.STAGE_A_R
    E = 1 << R
    tiles = x.reshape(W, B * n // T, T).clone()
    g = torch.arange(T >> R)
    for i, (c, s, e) in enumerate(N.stage_a_passes(log_b)):
        idx = [((g >> c) << (c + R)) | (k << c) | (g & ((1 << c) - 1)) for k in range(E)]
        assert torch.equal(torch.cat(idx).sort().values, torch.arange(T))
        v = [tiles[:, :, j] for j in idx]
        for b in range(s - c, e - c):
            st = c + b
            for kl in range(1 << b):
                w = tw[:, (1 << st) - 1 + ((kl << c) | (g & ((1 << c) - 1)))][:, None, :]
                for kh in range(E >> (b + 1)):
                    lo = (kh << (b + 1)) | kl
                    hi = lo | (1 << b)
                    t = v[hi] if i == 0 and kl == 0 else M.montmul_plain(FR_SPEC, w, v[hi])
                    v[lo], v[hi] = M.add(FR_SPEC, v[lo], t), M.sub(FR_SPEC, v[lo], t)
        for j, vk in zip(idx, v):
            tiles[:, :, j] = vk
    clusters = tiles.reshape(W, -1, 1 << cq, T)
    for q in range(cq):
        new = clusters.clone()
        for r in range(1 << cq):
            rlo, rhi = r & ~(1 << q), r | (1 << q)
            e = torch.arange(T // 2) + ((r >> q) & 1) * (T // 2)
            w = tw[:, (1 << (log_b + q)) - 1 + (((r & ((1 << q) - 1)) << log_b) | e)][:, None, :]
            a, b = clusters[:, :, rlo, e], clusters[:, :, rhi, e]
            t = M.montmul_plain(FR_SPEC, w, b)
            new[:, :, rlo, e], new[:, :, rhi, e] = M.add(FR_SPEC, a, t), M.sub(FR_SPEC, a, t)
        clusters = new
    return clusters.reshape(W, B, n)


@pytest.mark.parametrize("log_t, cq", [(3, 0), (4, 0), (5, 0), (8, 0), (6, 1), (7, 2), (8, 2)])
def test_stage_a_kernel_passes_emulated(log_t, cq):
    k = 8
    x = torch.stack([torch.as_tensor(FR_SPEC.encode(_ints(40 + s, 1 << k)))
                     for s in range(2)], dim=1)
    tw = N._twiddles_dev(k, False, "cpu")
    assert torch.equal(_stage_a_emulated(x, tw, log_t, cq),
                       N.stage_a_plain(FR_SPEC, x, tw, log_t))
