"""The port's phase spans follow the JAX package's rule, and its roofline
gives the kernel table's bounds (CPU).

Untraced, a proof calls its span fence no time, records no span and prints
nothing, and its bytes are the stored JAX proof's (tests/test_torch_prover.py).
Under WH2_TRACE, read as each span runs, every span fences at both ends,
records its seconds and prints a `[span]` line; keygen's spans do the same.
utils/roofline.py gives the bounds of PERF.md's kernel table at the timed
shapes, and `report` a row for each of the prover's phases and a total.
"""
import pytest
import torch

from test_torch_prover import CIRCUITS, JAX_REF, K, _det_rng, _keyed_and_proved
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk import prover as PR
from webauthn_halo2_tpu_torch.plonk.keygen import keygen
from webauthn_halo2_tpu_torch.plonk.srs import get_srs
from webauthn_halo2_tpu_torch.utils import roofline as RL

torch.set_num_threads(2)


def _toy_proof(monkeypatch, traced: bool) -> tuple:
    """A K=6 toy proof with the span fence counted: (proof, fences)."""
    _, pk, instances, _ = _keyed_and_proved("toy")
    _, _, advice, _, _ = CIRCUITS["toy"](CS)
    if traced:
        monkeypatch.setenv("WH2_TRACE", "1")
    else:
        monkeypatch.delenv("WH2_TRACE", raising=False)
    fences = []
    monkeypatch.setattr(PR._Span, "fence", staticmethod(fences.append))
    PR.LAST_SPANS.clear()
    proof = PR.create_proof(pk, advice, instances, rng=_det_rng(JAX_REF["toy"]["seed"]),
                            device="cpu")
    return proof, fences


def test_untraced_proof_makes_no_span_fence(monkeypatch, capsys):
    proof, fences = _toy_proof(monkeypatch, traced=False)
    assert fences == []
    assert PR.LAST_SPANS == {}
    assert "[span]" not in capsys.readouterr().err
    assert proof.hex() == JAX_REF["toy"]["proof"]


def test_traced_proof_fences_and_prints_every_span(monkeypatch, capsys):
    proof, fences = _toy_proof(monkeypatch, traced=True)
    assert list(PR.LAST_SPANS) == list(RL.PHASES)
    assert len(fences) == 2 * len(RL.PHASES)
    assert all(d.type == "cpu" for d in fences)
    err = capsys.readouterr().err
    for name in RL.PHASES:
        assert f"[span] {name}: " in err
    assert proof.hex() == JAX_REF["toy"]["proof"]


@pytest.mark.parametrize("traced", [False, True])
def test_keygen_spans_only_when_traced(traced, monkeypatch, capsys):
    if traced:
        monkeypatch.setenv("WH2_TRACE", "1")
    else:
        monkeypatch.delenv("WH2_TRACE", raising=False)
    cs, fixed, _, _, copies = CIRCUITS["toy"](CS)
    pk = keygen(get_srs(K, device="cpu"), cs, fixed, copies, device="cpu")
    err = capsys.readouterr().err
    if traced:
        assert list(pk.spans) == ["fixed cols", "fixed commits", "assemble perm",
                                  "sigma polys", "sigma commits", "indicator polys",
                                  "x_ext coset"]
        assert err.count("[span] ") == len(pk.spans)
    else:
        assert pk.spans == {} and "[span]" not in err
    assert pk.vk.transcript_repr == JAX_REF["toy"]["transcript_repr"]


# PERF.md's kernel table: (row, work at the timed shape, bound ms, bound by)
BOUNDS = [
    ("row 1 montmul (8, 2^19)", RL.montmul_work(1 << 19), 0.0150, "bytes"),
    ("row 2 stage A (8, 19, 2^19), 11 stages", RL.stage_a_work(19, 1 << 19, 11),
     0.685, "operations"),
    ("row 3 stage B (8, 19, 2^19), one stage", RL.stage_b_work(19, 1 << 19, 11),
     0.190, "bytes"),
    ("row 8 EC add (8, 180, 2048), 298,517 adds", RL.ec_add_work(180, 2048, 298517),
     0.0690, "operations"),
]


@pytest.mark.parametrize("row,work,ms,by", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_roofline_bounds_equal_the_kernel_table(row, work, ms, by):
    got, got_by = RL.bound_ms(work)
    assert round(got, 4 if ms < 0.1 else 3) == ms
    assert got_by == by


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_report_has_a_row_a_phase_and_a_total(scheme):
    _, pk, _, _ = _keyed_and_proved("toy")
    model = RL.proof_work_model(pk, scheme)
    assert list(model) == list(RL.PHASES)
    assert all(w["ops"] > 0 and w["bytes"] > 0 for w in model.values())
    spans = {name: 0.5 for name in RL.PHASES[:-1]}  # multiopen not timed
    rows = RL.report(spans, model)
    assert [r["phase"] for r in rows] == list(RL.PHASES) + ["total"]
    assert rows[-1]["s"] == pytest.approx(0.5 * (len(RL.PHASES) - 1))
    assert rows[-2]["s"] is None and rows[-2]["fraction"] is None
    assert rows[-1]["imad"] == sum(w["ops"] for w in model.values())
    for r in rows[:-2]:
        assert r["fraction"] == pytest.approx(r["bound_s"] / 0.5)
        assert r["bound_s"] == pytest.approx(RL.bound_ms(model[r["phase"]])[0] / 1e3)
    # the advice MSM counted dense, the lookup's always: upper counts
    assert [r["phase"] for r in rows if r["upper"]] == list(RL.PHASES[:2]) + ["total"]
    table = RL.format_report(rows)
    assert len(table.splitlines()) == len(rows) + 2  # a header and the footnote


def test_quotient_terms_count_the_gates_and_arguments():
    """The toy circuit's quotient a row: its gate q (a + b c - d) is two
    products and a scaled term (-d); the permutation (two columns, one
    chunk) 2 + 0 + 10 + 1 multiplies and a square; the lookup 10 and a
    square; five lookup and three permutation constraints with the gate
    folded by y (8 multiplies) and the division by Z_H (1)."""
    cs, *_ = CIRCUITS["toy"](CS)
    assert RL.quotient_terms(cs) == (3 + 13 + 10 + 8 + 1, 2)


def test_advice_msm_counts_the_columns_nonzero_digits():
    """Given the proof's advice, the advice commitment counts a mixed add
    for each nonzero digit of the columns (as the MSM kernel's bound does)
    and every digit of the blinding rows; without it, every digit."""
    _, pk, _, _ = _keyed_and_proved("toy")
    _, _, advice, _, _ = CIRCUITS["toy"](CS)
    n = pk.vk.domain.n
    usable = pk.vk.cs.usable_rows(n)
    c = RL._default_c(n)
    windows = -(-RL.SCALAR_BITS // c)
    brute = sum(((v % RL.BN254_FR) >> (c * w)) & ((1 << c) - 1) != 0
                for col in advice for v in col for w in range(windows))
    counted = RL.nonzero_digits(advice, n, usable)
    assert counted == brute + len(advice) * (n - usable) * windows
    dense = RL.proof_work_model(pk)["advice encode+commit"]
    sparse = RL.proof_work_model(pk, "shplonk", advice)["advice encode+commit"]
    assert dense["ops"] - sparse["ops"] == (
        RL.IMAD_PER_MADD * (windows * len(advice) * n - counted)) > 0
    assert dense["upper"] and "upper" not in sparse


@pytest.mark.parametrize("entry,scheme", [("generate_proof", "shplonk"),
                                          ("generate_proof_evm", "gwc")])
def test_a_traced_api_proof_reports_its_own_scheme(entry, scheme, monkeypatch, capsys):
    """A traced api proof prints the roofline of the scheme it proved with,
    its advice and lookup phases marked as upper counts (the key, witness
    and prover stubbed)."""
    from webauthn_halo2_tpu_torch import api

    _, pk, _, _ = _keyed_and_proved("toy")
    _, _, advice, _, _ = CIRCUITS["toy"](CS)
    seen = []
    monkeypatch.setenv("WH2_TRACE", "1")
    monkeypatch.setattr(api, "_keys", lambda *a: pk)
    monkeypatch.setattr(api, "_witness", lambda *a: (advice, []))
    monkeypatch.setattr(api, "create_proof", lambda *a, **kw: seen.append(kw) or b"p")
    model = RL.proof_work_model
    monkeypatch.setattr(RL, "proof_work_model",
                        lambda *a: seen.append(a[1:]) or model(*a))
    zero = bytes(32)
    assert getattr(api, entry)(zero, zero, zero, zero, zero, device="cpu") == b"p"
    assert seen[0].get("scheme", "shplonk") == scheme
    assert seen[1] == (scheme,)
    err = capsys.readouterr().err
    assert [line.endswith("*") for line in err.splitlines()
            if line.startswith(("advice", "lookup", "grand", "total"))] == [True, True, False, True]
    assert "* upper count" in err
