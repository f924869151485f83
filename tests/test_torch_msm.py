"""The port's serial Pippenger MSM against the JAX package's (CPU).

Bases are the first n points [tau^i] G of the committed k=17 dev SRS, so a
host oracle is one scalar multiply: sum_i k_i tau^i G = (sum_i k_i tau^i) G.
The JAX package's msm_batch on its XLA route takes about a minute to
compile at n = 2^8 on this CPU and more at 2^10, so its outputs are stored
below; the `slow` test recomputes them live.
"""
import os

import numpy as np
import pytest
import torch

from webauthn_halo2_tpu_torch import convert
from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE
from webauthn_halo2_tpu_torch.ops import ec as E
from webauthn_halo2_tpu_torch.ops import msm as MS

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

SRS17 = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                     "srs_bn254_k17_646576.npz")
BATCH = 2

# JAX msm_batch (XLA route) on _inputs(logn), as affine (x, y) hex
JAX_MSM = {
    8: [
        ("0x275d4d3ae6f1278737561dc25b5788c8158f1531baa418ed326731dc3caed58",
         "0xf665585b2f8de4549f4079b5b890d08de42b0edaea13a6cb1ed172fa8595c66"),
        ("0x28f5048e43b2a3ccd32bb6be9be21128e8d8ffed0de1078ed0809c0a1a1b6c17",
         "0x1e19b150aff52edf9d8848b337ffaded79a6d151d84689012d25c94f26abecbe"),
    ],
    10: [
        ("0x1713293dd690d718a594a29630c81eeaf4d0f440406634b3d85589429632dae0",
         "0x12431cfb285efe50546c505cb65fbf7461b1994e7e6b29f5103b34778b42d581"),
        ("0x1bdca46f3d710354f33da9a13f4698596ce70eda3b62372ea6545f3dcf9736b9",
         "0x2df67623a2b2034dc7454de3e55fce44889d680b2acea3b3e006ce62e7fd273b"),
    ],
}


def _tau() -> int:
    import hashlib

    h = hashlib.blake2b(b"webauthn-halo2-tpu/dev-srs/dev", digest_size=64)
    return int.from_bytes(h.digest(), "little") % BN254_FR


def _inputs(logn: int):
    """((3, 33, n) JAX-limb SRS bases, B lists of scalars)."""
    n = 1 << logn
    g = np.load(SRS17, allow_pickle=True)["g_mono"][:, :, :n]
    rng = np.random.default_rng(logn)
    scalars = []
    for _ in range(BATCH):
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        ks = [sum(int(w) << (32 * i) for i, w in enumerate(r)) % BN254_FR
              for r in words]
        ks[0], ks[1], ks[2] = 0, 1, BN254_FR - 1
        scalars.append(ks)
    return g, scalars


def _oracle(ks: list[int]):
    tau = _tau()
    s, t = 0, 1
    for k in ks:
        s = (s + k * t) % BN254_FR
        t = t * tau % BN254_FR
    return BN254_G1_CURVE.mul(s, BN254_G1_CURVE.g)


def _jax_msm(logn: int) -> list:
    import jax.numpy as jnp

    from webauthn_halo2_tpu.fields.limbs import FR_SPEC as J_FR
    from webauthn_halo2_tpu.ops import ec as JE
    from webauthn_halo2_tpu.ops import msm as JMS

    g, scalars = _inputs(logn)
    pts = JE.JPoint(*(jnp.asarray(c) for c in g))
    sc = jnp.stack([jnp.asarray(J_FR.encode(ks)) for ks in scalars])
    return JE.to_affine_ints(JE.BN254_CURVE, JMS.msm_batch(JE.BN254_CURVE, pts, sc))


def _hex(pts):
    return [None if p is None else (hex(p[0]), hex(p[1])) for p in pts]


@pytest.mark.parametrize("logn", [8, 10])
def test_msm_batch_matches_jax_and_oracle(logn):
    g, scalars = _inputs(logn)
    pts = convert.point_from_jax(*g, device="cpu")
    sc = torch.stack([torch.as_tensor(FR_SPEC.encode(ks)) for ks in scalars], dim=1)
    got = MS.msm_batch(E.BN254_CURVE, pts, sc)
    assert got == [_oracle(ks) for ks in scalars]
    assert _hex(got) == JAX_MSM[logn]


def test_msm_repeated_bucket_and_edge_scalars():
    """Long runs of one digit (all scalars equal) and the scalars 0, 1, r-1."""
    g, _ = _inputs(6)
    pts = convert.point_from_jax(*g, device="cpu")
    for ks in ([3] * 64, [0] * 63 + [BN254_FR - 1]):
        got = MS.msm(E.BN254_CURVE, pts, torch.as_tensor(FR_SPEC.encode(ks)))
        assert got == _oracle(ks)


def test_scalar_digits_recompose():
    vals = [0, 1, BN254_FR - 1, 0x1234567890ABCDEF << 100]
    std = torch.as_tensor(FR_SPEC.encode(vals, mont=False))
    for c in (4, 6, 13):
        d = MS.scalar_digits(std, c)
        assert [sum(int(d[w, i]) << (c * w) for w in range(d.shape[0]))
                for i in range(len(vals))] == vals


@pytest.mark.slow
@pytest.mark.parametrize("logn", [8, 10])
def test_stored_jax_msm_is_current(logn):
    assert _hex(_jax_msm(logn)) == JAX_MSM[logn]


def test_ec_ops_match_host_curve():
    """Complete add (P+Q, P+P, P-P, P+inf), add_unsafe, double and
    is_on_curve against ref_curve's affine arithmetic."""
    G = BN254_G1_CURVE
    g, _ = _inputs(3)
    ps = E.to_affine_ints(E.BN254_CURVE, convert.point_from_jax(*g, device="cpu"))
    a = [ps[0], ps[1], ps[2], None, ps[3], ps[4]]
    b = [ps[5], ps[1], G.neg(ps[2]), ps[6], None, ps[7]]
    P = E.from_affine_ints(E.BN254_CURVE, a)
    Q = E.from_affine_ints(E.BN254_CURVE, b)
    assert E.to_affine_ints(E.BN254_CURVE, E.add(E.BN254_CURVE, P, Q)) == \
        [G.add(x, y) for x, y in zip(a, b)]
    assert E.to_affine_ints(E.BN254_CURVE, E.double(E.BN254_CURVE, P)) == \
        [G.add(x, x) for x in a]
    keep = [0, 3, 4, 5]  # add_unsafe: distinct points or infinities only
    got = E.add_unsafe(E.BN254_CURVE, MS._pt_cols(P, keep), MS._pt_cols(Q, keep))
    assert E.to_affine_ints(E.BN254_CURVE, got) == [G.add(a[i], b[i]) for i in keep]
    assert E.is_on_curve(E.BN254_CURVE, P).all()
    off = E.JPoint(P.x, P.x, P.z)  # y = x is off the curve for these points
    assert not E.is_on_curve(E.BN254_CURVE, off)[0]


def test_srs_from_npz_matches_get_srs():
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    path = SRS17.replace("k17", "k6")
    srs = convert.srs_from_npz(path, device="cpu")
    ref = get_srs(6, device="cpu")
    assert srs.k == 6 and srs.g2 == ref.g2 and srs.s_g2 == ref.s_g2
    pts = E.to_affine_ints(E.BN254_CURVE, srs.g_mono)
    assert pts[0] == BN254_G1_CURVE.g
    assert pts[1] == BN254_G1_CURVE.mul(_tau(), BN254_G1_CURVE.g)
    assert all(BN254_G1_CURVE.is_on_curve(p) for p in pts)
