"""The port's int8 tensor-core Montgomery multiply (ops/mxu_mod.py) against
the JAX package's (CPU).

On a CPU tensor `mxu_montmul_rows` takes its plain version, the kernel's
steps in plain PyTorch; csrc/mxu.cu runs only on the card, where
chip_smoke.py holds it against that plain version and the montmul kernel.
The two packages keep Montgomery values with different R (2^256 against
2^264) and the JAX output is lazy, so they are compared as canonical
integers; against the port's own montmul the words must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webauthn_halo2_tpu.fields.limbs import FR_SPEC as J_FR
from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC
from webauthn_halo2_tpu_torch.ops import modops as M
from webauthn_halo2_tpu_torch.ops import mxu_mod as X

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

SPECS = {"fr": FR_SPEC, "fq": FQ_SPEC}


def _ints(seed: int, p: int, n: int) -> list[int]:
    """Random values below p, with the edge values 0, 1, 2, p-2, p-1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    vals[:5] = [0, 1, 2, p - 2, p - 1]
    return vals


@pytest.mark.parametrize("name", sorted(SPECS))
def test_constants_fit_int8_and_invert_the_vandermonde(name):
    spec = SPECS[name]
    cs = X.consts(spec)
    assert cs.ev.dtype == cs.iv.dtype == cs.fold.dtype == np.int8
    assert cs.ev.shape == X.EVAL_SHAPE and cs.fold.shape == X.FOLD_SHAPE
    assert cs.iv.shape == (2,) + X.INTERP_SHAPE
    assert cs.fold.min() >= 0 and cs.fold.max() <= 15
    # every product coefficient sum_{i+j=t} a_i b_j is below q1 q2
    assert X.NL * 255 ** 2 < X.Q1 * X.Q2
    ev = cs.ev.astype(np.int64)
    for P, q in enumerate((X.Q1, X.Q2)):
        # EVAL digit pairs recombine to 2^(7d) u^i mod q
        cols = ev[:, P * 128:(P + 1) * 128].reshape(64, 64, 2)
        val = cols[..., 0] + 256 * cols[..., 1]
        for d, i, u in ((0, 3, 5), (1, 31, 62), (0, 0, 0)):
            assert val[d * 32 + i, u] == (pow(u, i, q) << (7 * d)) % q
        # INTERP (plane 0, with its 2^16) times the Vandermonde is 2^16 I
        iv = cs.iv[P].astype(np.int64)
        vi = (iv[:X.T, 0:2 * X.T:2] + 256 * iv[:X.T, 1:2 * X.T:2]) % q  # [u, t]
        vand = np.array([[pow(u, i, q) for i in range(X.T)] for u in range(X.T)],
                        dtype=np.int64)  # [u, i]
        assert ((vi.T @ vand) % q == (np.eye(X.T, dtype=np.int64) * X.R16) % q).all()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_equals_montmul_word_for_word(name):
    spec = SPECS[name]
    a = torch.as_tensor(spec.encode(_ints(1, spec.p, 512)))
    b = torch.as_tensor(spec.encode(_ints(2, spec.p, 512)[::-1]))
    assert torch.equal(X.mxu_montmul_rows(spec, a, b), M.montmul_plain(spec, a, b))
    assert torch.equal(X.mxu_montmul_rows(spec, a, a), M.montmul_plain(spec, a, a))


def test_plain_matches_jax_mxu_montmul_rows_in_interpret_mode():
    from webauthn_halo2_tpu.ops.mxu_mod import mxu_montmul_rows

    xs, ys = _ints(3, FR_SPEC.p, 256), _ints(4, FR_SPEC.p, 256)
    got = FR_SPEC.decode(X.mxu_montmul_rows(
        FR_SPEC, torch.as_tensor(FR_SPEC.encode(xs)), torch.as_tensor(FR_SPEC.encode(ys))).numpy())
    jout = mxu_montmul_rows(J_FR, jnp.asarray(J_FR.encode(xs).T), jnp.asarray(J_FR.encode(ys).T),
                            block=128)
    want = J_FR.decode(np.asarray(jout).T)
    assert got == want == [x * y % FR_SPEC.p for x, y in zip(xs, ys)]


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    a = torch.as_tensor(FR_SPEC.encode([5, 7]))
    with pytest.raises(ValueError, match="CUDA"):
        X.mxu_montmul_rows_cuda(FR_SPEC, a, a)
    X.mxu_montmul_rows(FR_SPEC, a, a)
    assert X.LAUNCHES == {"mxu_montmul": 0}
