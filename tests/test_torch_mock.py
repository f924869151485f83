"""The port's mock prover against the JAX package's (CPU).

At K=6 both mock provers run live on the same witnesses, a satisfied one
and one broken in each way the mock reports (a gate row, more gate rows
than `max_failures`, a bare-column lookup, a lookup of a rotated column,
a copy), and their findings must be equal, string for string. Then the
ES256/WebAuthn circuit at k=17, synthesised once by the port: its digest
(`pk_cache.synthesis_digest`), the port's findings on its witness (none)
and on the witness with one advice cell of the SHA-256 region plus one
must equal the JAX package's, stored here (the JAX mock takes minutes at
k=17 on this CPU). The `slow` test recomputes them from the JAX package.
"""
import pytest
import torch

from webauthn_halo2_tpu.plonk import cs as JCS
from webauthn_halo2_tpu.plonk.mock import mock_prove as jax_mock_prove
from webauthn_halo2_tpu_torch.circuits.es256_circuit import ES256Circuit, ES256Inputs
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk.mock import mock_prove
from webauthn_halo2_tpu_torch.plonk.pk_cache import synthesis_digest

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it.
torch.set_num_threads(2)

K = 6


def mock_circuit(cs_mod):
    """(cs, fixed, advice, copies): a vertical gate on advice 0 under the
    selector fixed 0; a range lookup of the bare advice 1 into fixed 1 (the
    mock's fast path); a lookup of advice 2 at rotation 1 (its general
    path); copies within advice 0 and from advice 0 into advice 1."""
    cs = cs_mod.ConstraintSystem(num_fixed=2, num_advice=3)
    cs.gate("vgate", cs_mod.fixed(0) * (cs_mod.advice(0, 0) + cs_mod.advice(0, 1)
                                        * cs_mod.advice(0, 2) - cs_mod.advice(0, 3)))
    cs.lookup("range8", [cs_mod.advice(1)], [cs_mod.fixed(1)])
    cs.lookup("next8", [cs_mod.advice(2, 1)], [cs_mod.fixed(1)])
    for i in range(3):
        cs.enable_permutation(cs_mod.ADVICE, i)
    n = 1 << K
    usable = cs.usable_rows(n)
    adv0 = [3, 5, 7, 38, 38, 2, 4, 46] + [0] * (usable - 8)
    adv1 = [1, 6, 5, 7, 0, 2] + [0] * (usable - 6)
    adv2 = [7, 3, 0, 4, 4, 1] + [0] * (usable - 6)
    q = [1, 0, 0, 0, 1, 0, 0, 0] + [0] * (n - 8)
    table = list(range(8)) + [0] * (n - 8)
    copies = [((cs_mod.ADVICE, 0, 3), (cs_mod.ADVICE, 0, 4)),
              ((cs_mod.ADVICE, 0, 1), (cs_mod.ADVICE, 1, 2))]
    return cs, [q, table], [adv0, adv1, adv2], copies


def _set(col: int, row: int, value: int):
    def edit(fixed, advice):
        advice[col][row] = value
    return edit


def _all_rows_selected(fixed, advice):
    fixed[0][:50] = [1] * 50
    advice[0][8:50] = [1] * 42  # 1 + 1 * 1 != 1 on every row from 8


# name -> (witness edit, max_failures)
CASES = {
    "satisfied": (lambda fixed, advice: None, 10),
    "gate_row": (_set(0, 7, 47), 10),
    "gate_rows_past_max_failures": (_all_rows_selected, 10),
    "bare_column_lookup": (_set(1, 3, 9), 10),
    "rotated_lookup": (_set(2, 4, 8), 10),
    "copy": (_set(1, 2, 6), 10),
    "several_with_a_low_max_failures": (
        lambda fixed, advice: [_set(1, r, 9)(fixed, advice) for r in range(4)], 2),
}


def _findings(cs_mod, run, case: str, **kw) -> list:
    cs, fixed, advice, copies = mock_circuit(cs_mod)
    edit, max_failures = CASES[case]
    edit(fixed, advice)
    return run(cs, K, fixed, advice, copies=copies, max_failures=max_failures, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mock_findings_match_jax(case):
    port = _findings(CS, mock_prove, case, device="cpu")
    assert port == _findings(JCS, jax_mock_prove, case)
    assert (port == []) == (case == "satisfied")


# ES256 at k=17: the advice cell made wrong (a gate column, inside the rows
# the SHA-256 chip fills before the ECDSA gadget) and the JAX package's
# outputs for ES256Inputs.dummy()
TAMPER = (1, 8000)
ES256_JAX = dict(
    digest="6920c13c1047787b189357715cdf2058197cc5e58399ae523540a75ec4593b00",
    tampered=["gate 'vgate1' not satisfied at row 7997",
              "copy (advice1[8000]) == (advice10[5242]) violated: 1 != 0"],
)


@pytest.fixture(scope="module")
def es256():
    circ = ES256Circuit()
    return circ.params.degree, circ.build(ES256Inputs.dummy())


def _tampered(advice: list) -> list:
    col, row = TAMPER
    out = list(advice)
    out[col] = list(advice[col])
    out[col][row] += 1
    return out


def test_es256_synthesis_matches_jax(es256):
    _, (cs, fixed, advice, copies) = es256
    assert synthesis_digest(cs, fixed, advice, copies) == ES256_JAX["digest"]


def test_es256_mock_is_satisfied(es256):
    k, (cs, fixed, advice, copies) = es256
    assert mock_prove(cs, k, fixed, advice, copies=copies, device="cpu") == []


def test_es256_tampered_witness_gives_the_jax_findings(es256):
    k, (cs, fixed, advice, copies) = es256
    got = mock_prove(cs, k, fixed, _tampered(advice), copies=copies, device="cpu")
    assert got == ES256_JAX["tampered"]


@pytest.mark.slow
def test_stored_es256_values_are_current():
    """Regenerates ES256_JAX from the JAX package (minutes on this CPU)."""
    from webauthn_halo2_tpu.circuits.es256_circuit import ES256Circuit as JES256Circuit
    from webauthn_halo2_tpu.circuits.es256_circuit import ES256Inputs as JES256Inputs

    circ = JES256Circuit()
    k = circ.params.degree
    cs, fixed, advice, copies = circ.build(JES256Inputs.dummy())
    assert synthesis_digest(cs, fixed, advice, copies) == ES256_JAX["digest"]
    assert jax_mock_prove(cs, k, fixed, advice, copies=copies) == []
    assert jax_mock_prove(cs, k, fixed, _tampered(advice), copies=copies) == \
        ES256_JAX["tampered"]
