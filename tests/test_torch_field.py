"""The port's field core against the JAX package's (CPU).

Both sides get the same inputs, made with numpy from a seed; results are
compared as canonical integers (the two packages store Montgomery values
with different R, 2^256 against 2^264), exactly: field arithmetic has no
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webauthn_halo2_tpu.fields.limbs import FQ_SPEC as J_FQ
from webauthn_halo2_tpu.fields.limbs import FR_SPEC as J_FR
from webauthn_halo2_tpu.ops import modops as JM
from webauthn_halo2_tpu.ops.pallas_kernels import montmul_pallas
from webauthn_halo2_tpu_torch import convert
from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC, ints_to_words, words_to_ints
from webauthn_halo2_tpu_torch.ops import modops as M

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

N = 512
SPECS = {"fr": (FR_SPEC, J_FR), "fq": (FQ_SPEC, J_FQ)}


def _ints(seed: int, p: int, n: int = N) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    vals[0], vals[1], vals[2] = 0, 1, p - 1
    return vals


@pytest.fixture(scope="module", params=sorted(SPECS))
def field(request):
    spec, jspec = SPECS[request.param]
    xs, ys = _ints(1, spec.p), _ints(2, spec.p)
    ys[3] = xs[3]  # one equal pair for eq
    port = (torch.as_tensor(spec.encode(xs)), torch.as_tensor(spec.encode(ys)))
    jax_ = (jnp.asarray(jspec.encode(xs)), jnp.asarray(jspec.encode(ys)))
    return spec, jspec, xs, ys, port, jax_


def test_codec_round_trip():
    vals = _ints(3, 1 << 256) + [(1 << 256) - 1]
    words = ints_to_words(vals)
    assert words.shape == (8, len(vals)) and words.dtype == np.int32
    assert words_to_ints(words) == vals
    assert FR_SPEC.decode(FR_SPEC.encode(vals)) == [v % FR_SPEC.p for v in vals]


@pytest.mark.parametrize("mont", [True, False])
def test_field_from_jax(mont):
    vals = _ints(4, J_FR.p)
    jl = np.asarray(J_FR.encode(vals, mont=mont))
    got = convert.field_from_jax(jl, FR_SPEC, mont=mont, device="cpu")
    assert FR_SPEC.decode(got.numpy(), mont=mont) == vals
    # lazy JAX limbs (a montmul output, < 2p, limbs above 255) decode too
    lazy = np.asarray(JM.montmul(J_FR, jnp.asarray(jl), jnp.asarray(jl)))
    got = convert.field_from_jax(lazy, FR_SPEC, mont=mont, device="cpu")
    assert FR_SPEC.decode(got.numpy(), mont=mont) == J_FR.decode(lazy, mont=mont)


BINARY = {
    "add": (M.add, JM.add),
    "sub": (M.sub, JM.sub),
    "montmul": (M.montmul, JM.montmul),
}
# name -> (port op, JAX op, input in Montgomery form, output in Montgomery form)
UNARY = {
    "neg": (lambda s, a: M.neg(s, a), lambda s, a: JM.neg(s, a), True, True),
    "mul_const": (lambda s, a: M.mul_const(s, a, 7),
                  lambda s, a: JM.mul_const(s, a, 7), True, True),
    "montsquare": (M.montsquare, JM.montsquare, True, True),
    "to_mont": (M.to_mont, JM.to_mont, False, True),
    "from_mont": (M.from_mont, JM.from_mont, True, False),
    "normalize": (M.normalize, JM.normalize, False, False),
    "pow_const": (lambda s, a: M.pow_const(s, a, 0x1234567),
                  lambda s, a: JM.pow_const(s, a, 0x1234567), True, True),
    "inv_fermat": (M.inv_fermat, JM.inv_fermat, True, True),
    "prefix_mul": (lambda s, a: M.prefix_mul(s, a[:, None, :], 2),
                   lambda s, a: JM.prefix_mul(s, a[:, None, :], 2), True, True),
    "suffix_mul": (lambda s, a: M.prefix_mul(s, a, 1, True),
                   lambda s, a: JM.prefix_mul(s, a, 1, True), True, True),
    "batch_inverse": (lambda s, a: M.batch_inverse(s, a, 1),
                      lambda s, a: JM.batch_inverse(s, a, 1), True, True),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches_jax(field, op):
    spec, jspec, _, _, (a, b), (ja, jb) = field
    port_fn, jax_fn = BINARY[op]
    assert spec.decode(port_fn(spec, a, b).numpy()) == jspec.decode(np.asarray(jax_fn(jspec, ja, jb)))


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op_matches_jax(field, op):
    spec, jspec, xs, _, _, _ = field
    port_fn, jax_fn, in_mont, out_mont = UNARY[op]
    if op == "inv_fermat":  # ~380 dependent multiplies: a slice keeps it quick
        xs = xs[:16]
    a = torch.as_tensor(spec.encode(xs, mont=in_mont))
    ja = jnp.asarray(jspec.encode(xs, mont=in_mont))
    got = spec.decode(port_fn(spec, a).numpy(), mont=out_mont)
    assert got == jspec.decode(np.asarray(jax_fn(jspec, ja)), mont=out_mont)


def test_predicates_and_select_match_jax(field):
    spec, jspec, _, _, (a, b), (ja, jb) = field
    assert M.is_zero(spec, a).tolist() == np.asarray(JM.is_zero(jspec, ja)).tolist()
    assert M.eq(spec, a, b).tolist() == np.asarray(JM.eq(jspec, ja, jb)).tolist()
    cond = np.arange(N) % 3 == 0
    got = M.select(torch.as_tensor(cond), a, b)
    want = JM.select(jnp.asarray(cond), ja, jb)
    assert spec.decode(got.numpy()) == jspec.decode(np.asarray(want))


def test_every_output_fully_reduced(field):
    spec, _, _, _, (a, b), _ = field
    for out in (M.add(spec, a, b), M.sub(spec, a, b), M.montmul(spec, a, b)):
        assert max(words_to_ints(out.numpy())) < spec.p


def test_montmul_plain_matches_pallas_interpret():
    """The plain version of the montmul kernel against the TPU kernel run
    in interpret mode at (33, 512), as tests/test_pallas.py runs it."""
    xs, ys = _ints(5, J_FR.p), _ints(6, J_FR.p)
    want = J_FR.decode(np.asarray(montmul_pallas(
        J_FR, jnp.asarray(J_FR.encode(xs)), jnp.asarray(J_FR.encode(ys)))))
    got = M.montmul_plain(FR_SPEC, torch.as_tensor(FR_SPEC.encode(xs)),
                          torch.as_tensor(FR_SPEC.encode(ys)))
    assert FR_SPEC.decode(got.numpy()) == want
    assert want == [x * y % J_FR.p for x, y in zip(xs, ys)]


def test_montmul_wrapper_on_cpu_takes_the_plain_version():
    a = torch.as_tensor(FR_SPEC.encode(_ints(7, FR_SPEC.p, 8)))
    before = M.LAUNCHES["montmul"]
    assert torch.equal(M.montmul(FR_SPEC, a, a), M.montmul_plain(FR_SPEC, a, a))
    assert M.LAUNCHES["montmul"] == before
    with pytest.raises(ValueError):
        M.montmul_cuda(FR_SPEC, a, a)


def test_montmul_kernel_operands():
    """What montmul_cuda hands the kernel, on CPU tensors: a (8, 1)
    constant broadcasts (no limb stride needed), a slice of a stacked
    (8, B, n) tensor keeps its limb stride and needs no copy, and a ragged
    width is taken as it is."""
    n = 64
    stack = torch.zeros((8, 3, n + 2), dtype=torch.int32)
    dense = torch.zeros((8, 2, n), dtype=torch.int32)
    c = torch.zeros((8, 1), dtype=torch.int32)
    assert M._kernel_operand(c, (n,))[1:] == (1, 1)
    assert M._kernel_operand(dense[:, 1], (n,))[1:] == (2 * n, 0)
    sl = stack[:, 1, :n]
    t, ls, bc = M._kernel_operand(sl, (n,))
    assert (ls, bc) == (3 * (n + 2), 0) and t.data_ptr() == sl.data_ptr()
    ragged = torch.zeros((8, 2, n + 3), dtype=torch.int32)
    assert M._kernel_operand(ragged[:, 0], (n + 3,))[1:] == (2 * (n + 3), 0)
