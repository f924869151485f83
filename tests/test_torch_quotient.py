"""The port's windowed quotient (WH2_QUOTIENT_CHUNKS) equals the full-width
one (CPU).

The JAX package's memory mode (tests/test_quotient_chunked.py): h is
evaluated over circular windows of the extended domain, each rotation a
window of its source, and the windows are joined. On the K=6 toy key of
tests/test_torch_prover.py, `FusedPhases.quotient` at 1, 2 and 4 windows
equals a full-width evaluation that rolls each rotated source, a proof at
4 windows equals the stored JAX bytes, and a count that does not divide
the extended domain raises.
"""
import random

import pytest
import torch

from test_torch_prover import CIRCUITS, JAX_REF, _det_rng, _keyed_and_proved
from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk import prover as PR
from webauthn_halo2_tpu_torch.plonk.fused import batched_c2e

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def toy_inputs():
    """The toy key's phase functions and a random extended stack of its
    quotient's rows (the values do not matter: every window must give the
    whole domain's result on any input)."""
    _, pk, _, _ = _keyed_and_proved("toy")
    fp = PR._fused_for(pk)
    domain = pk.vk.domain
    rng = random.Random(6)
    vals = [rng.randrange(BN254_FR) for _ in range(fp.m_stack * domain.n)]
    coeff = torch.as_tensor(FR_SPEC.encode(vals)).reshape(8, fp.m_stack, domain.n)
    ext = batched_c2e(domain.k, domain.extended_k, coeff)
    consts = [FR_SPEC.encode([v]) for v in (5, 7, 11)]
    return fp, ext, [torch.as_tensor(c) for c in consts]


def _rolled(fp, ext, beta, gamma, y, monkeypatch):
    """fp.quotient evaluated at full width with every rotation a
    torch.roll of its source: the result each window count must give."""
    ratio = fp.domain.ext_n // fp.n
    body = PR._quotient_body

    def rolled(*args):
        return body(*args[:-1], lambda src, rot: torch.roll(src, -rot * ratio, dims=-1))

    with monkeypatch.context() as m:
        m.setattr(PR, "_quotient_body", rolled)
        m.setenv("WH2_QUOTIENT_CHUNKS", "1")
        return fp.quotient(ext, beta, gamma, y)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_windows_equal_the_whole_domain(chunks, toy_inputs, monkeypatch):
    fp, ext, (beta, gamma, y) = toy_inputs
    whole = _rolled(fp, ext, beta, gamma, y, monkeypatch)
    monkeypatch.setenv("WH2_QUOTIENT_CHUNKS", str(chunks))
    assert torch.equal(fp.quotient(ext, beta, gamma, y), whole)


def test_a_proof_at_four_windows_equals_the_jax_bytes(monkeypatch):
    _, pk, instances, _ = _keyed_and_proved("toy")
    _, _, advice, _, _ = CIRCUITS["toy"](CS)
    monkeypatch.setenv("WH2_QUOTIENT_CHUNKS", "4")
    proof = PR.create_proof(pk, advice, instances, rng=_det_rng(JAX_REF["toy"]["seed"]),
                            device="cpu")
    assert proof.hex() == JAX_REF["toy"]["proof"]


@pytest.mark.parametrize("chunks", ["3", "0"])
def test_a_count_that_does_not_divide_the_domain_raises(chunks, toy_inputs, monkeypatch):
    fp, ext, (beta, gamma, y) = toy_inputs
    monkeypatch.setenv("WH2_QUOTIENT_CHUNKS", chunks)
    with pytest.raises(ValueError, match="does not divide the extended domain of 256"):
        fp.quotient(ext, beta, gamma, y)
