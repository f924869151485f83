"""Whole runs of the harness on the CPU with the toy system (the look for
a card skipped): unbroken, `correct` is true; with each fault planted under
the timed path (bp/pool.py FAULTS), it is false; a signature outside the
circuit's domain fails its call under "uniform" traffic and leaves the run
correct, and the cells' "in_domain" traffic draws it again."""
import json

import pytest

import harness_util
import run
from bp import plain, pool, reference as ref

SEED = 2 ** 33  # every request of rank 0 and rank 1 that a toy run makes lies inside the domain
OUTSIDE = 2 ** 33 + 24  # rank 0's first request lies outside it


def _run(tmp_path, capsys, fault, ranks=1, seed=SEED, signatures="in_domain"):
    root = harness_util.toy_root(str(tmp_path), ranks=ranks, signatures=signatures)
    rc = run.main(["--workload", "toy.pool", "--seed", str(seed), "--seconds", "1",
                   "--trace", "0"], root=root, device="cpu", system="toy_system:ToySystem",
                  fault=fault)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_an_unbroken_run_is_correct(tmp_path, capsys):
    res = _run(tmp_path, capsys, None)
    assert res["correct"] and res["attempted"] == 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"proofs_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["witnesses_unchecked"]["value"] == 0


def test_a_signature_outside_the_domain_fails_its_call_and_the_run_stays_correct(tmp_path, capsys):
    assert not ref.in_domain(plain.ecdsa_request(OUTSIDE, "rank 0", 0))
    assert all(ref.in_domain(plain.ecdsa_request(OUTSIDE, "rank 0", i)) for i in range(1, 6))
    res = _run(tmp_path, capsys, None, seed=OUTSIDE, signatures="uniform")
    assert res["correct"] and res["failed"] == 2 and res["attempted"] >= 4
    assert res["checks"]["unexpected_errors"]["value"] == 0


def test_the_cells_traffic_draws_such_a_signature_again_and_no_request_fails(tmp_path, capsys):
    req, again = pool.traffic_request(OUTSIDE, "rank 0", 0, "in_domain")
    assert again >= 1 and ref.in_domain(req) and plain.ecdsa_valid(req)
    assert pool.traffic_request(OUTSIDE, "rank 0", 1, "in_domain") == (
        plain.ecdsa_request(OUTSIDE, "rank 0", 1), 0)
    res = _run(tmp_path, capsys, None, seed=OUTSIDE)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2


@pytest.mark.parametrize("fault,number", [("control", "proofs_rejected"),
                                          ("altered", "proofs_rejected"),
                                          ("half", "proofs_missing"),
                                          ("stale", "witness_faults"),
                                          ("error", "unexpected_errors")])
def test_a_broken_run_is_not_correct(tmp_path, capsys, fault, number):
    res = _run(tmp_path, capsys, fault)
    assert not res["correct"] and res["checks"][number]["value"] > 0


def test_a_lost_rank_is_not_correct(tmp_path, capsys):
    res = _run(tmp_path, capsys, "exchange", ranks=2)
    assert not res["correct"] and res["checks"]["ranks_missing"]["value"] == 1
