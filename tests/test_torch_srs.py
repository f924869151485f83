"""The port's SRS generation against the JAX package's (CPU).

The port generates the dev SRS as the JAX package does (plonk/srs.py):
the same tau, the same host scalars, a fixed-base window table and
complete adds on the device, then affine. Its points must equal the
committed SRS where there is one (k=6) and the host multiples of the
host scalars everywhere; G2 and [tau]G2 equal the JAX package's. A degree
without any file is generated, saved in the port's format, reloaded
equal, and passes the pairing check. The `slow` test runs the JAX
package's generate_srs live. (The k=4 JAX-format file is not committed:
the JAX package's tests make it when they first ask for it.)
"""
import random

import numpy as np
import pytest
import torch

from webauthn_halo2_tpu_torch.fields.pairing import pairing_check
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G
from webauthn_halo2_tpu_torch.ops import ec as E
from webauthn_halo2_tpu_torch.plonk import srs as S

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it.
torch.set_num_threads(2)


def _equal_points(a: E.JPoint, b: E.JPoint) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _affine(srs: S.SRS, which: str, idx: list) -> list:
    pts = getattr(srs, which)
    return E.to_affine_ints(E.BN254_CURVE, E.JPoint(*(c[:, idx] for c in pts)))


def _check_against_host(srs: S.SRS, idx: list) -> None:
    powers, lag = S.srs_scalars(srs.k, srs.tau_seed)
    for which, scalars in (("g_mono", powers), ("g_lag", lag)):
        got = _affine(srs, which, idx)
        assert got == [G.mul(scalars[i], G.g) for i in idx], which
        # affine words: z is exactly Montgomery one
        z = getattr(srs, which).z
        assert torch.equal(z, E.M.one_mont(E.FQ_SPEC, "cpu").expand(z.shape))


@pytest.mark.parametrize("k", [4, 6])
def test_generate_srs_equals_the_reference(k, monkeypatch):
    monkeypatch.setenv("WH2_TRACE", "1")  # the spans are recorded only traced
    srs = S.generate_srs(k, device="cpu")
    assert srs.n == 1 << k and srs.g_mono.x.shape == (8, 1 << k)
    _check_against_host(srs, list(range(1 << k)))
    assert srs.g2 == S.G2_GEN
    assert srs.s_g2 == S.g2_mul(S.derive_tau(b"dev"), S.G2_GEN)
    assert set(srs.spans) == {"host scalars", "window table", "fixed-base multiply",
                              "to affine"}
    if k == 6:  # the committed JAX-format file, as get_srs loads it
        ref = S.get_srs(k, device="cpu")
        assert _equal_points(srs.g_mono, ref.g_mono)
        assert _equal_points(srs.g_lag, ref.g_lag)
        assert (srs.g2, srs.s_g2) == (ref.g2, ref.s_g2)


def test_get_srs_generates_saves_and_reloads_a_degree_without_a_file(tmp_path, monkeypatch):
    monkeypatch.setattr(S, "_SRS_MEM_CACHE", {})
    monkeypatch.setenv("WH2_TRACE", "1")  # a generated SRS then carries its spans
    jax_path, port_path = S.srs_paths(5, b"dev", str(tmp_path))
    srs = S.get_srs(5, cache_dir=str(tmp_path), device="cpu")
    assert srs.spans and sorted(p.name for p in tmp_path.iterdir()) == [
        "srs_bn254_k5_646576.torch.npz"]
    assert port_path == str(tmp_path / "srs_bn254_k5_646576.torch.npz")
    assert S.get_srs(5, cache_dir=str(tmp_path), device="cpu") is srs
    S._SRS_MEM_CACHE.clear()
    again = S.get_srs(5, cache_dir=str(tmp_path), device="cpu")
    assert again is not srs and not again.spans
    assert _equal_points(again.g_mono, srs.g_mono) and _equal_points(again.g_lag, srs.g_lag)
    assert (again.k, again.tau_seed, again.g2, again.s_g2) == (5, b"dev", srs.g2, srs.s_g2)
    idx = sorted(random.Random(5).sample(range(32), 8))
    _check_against_host(again, idx)
    # e([tau]G1, G2) == e(G1, [tau]G2)
    tau_g1 = _affine(again, "g_mono", [1])[0]
    assert pairing_check([(tau_g1, again.g2), (G.neg(G.g), again.s_g2)])
    assert not pairing_check([(tau_g1, again.g2), (G.neg(G.g), again.g2)])


def test_load_port_srs_refuses_another_format(tmp_path):
    jax_file, _ = S.srs_paths(6)
    with pytest.raises(ValueError, match="format"):
        S.load_port_srs(jax_file, device="cpu")
    np.savez(tmp_path / "x.torch.npz", format=np.frombuffer(b"other", np.uint8))
    with pytest.raises(ValueError, match="format"):
        S.load_port_srs(str(tmp_path / "x.torch.npz"), device="cpu")


def test_host_parts_match_jax():
    """derive_tau, g2_mul and the digits of the JAX package's loop."""
    from webauthn_halo2_tpu.plonk import srs as J

    for seed in (b"dev", b"", b"other seed"):
        assert S.derive_tau(seed) == J.derive_tau(seed)
    for k in (1, 2, 3, 0xFFFF, S.derive_tau(b"dev")):
        assert S.g2_mul(k, S.G2_GEN) == J.g2_mul(k, J.G2_GEN)
    assert S.g2_add(S.G2_GEN, None) == S.G2_GEN
    rnd = random.Random(7)
    scalars = [0, 1, 255, 256, S.BN254_FR - 1] + [rnd.getrandbits(254) for _ in range(20)]
    digits = S.scalar_digits(scalars)
    want = np.array([[(s >> (8 * j)) & 255 for s in scalars] for j in range(32)])
    assert np.array_equal(digits, want)


@pytest.mark.slow
def test_generate_srs_matches_jax_live():
    """The JAX package's generate_srs(4), run live, against the port's."""
    from webauthn_halo2_tpu.plonk import srs as J
    from webauthn_halo2_tpu_torch.convert import point_from_jax

    ref = J.generate_srs(4)
    port = S.generate_srs(4, device="cpu")
    for which in ("g_mono", "g_lag"):
        pts = getattr(ref, which)
        want = point_from_jax(*(np.asarray(c) for c in pts), device="cpu")
        assert _equal_points(getattr(port, which), want), which
    assert (port.g2, port.s_g2) == (ref.g2, ref.s_g2)
