"""On a card only: the control at the k=17 cell's own size comes out not
correct, and an unbroken run of the same cell comes out correct. Run from
the root of a checkout on a machine with a card:
    python -m pytest bench_port/tests/test_port_bench_card.py -q"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only there")


def _results(args):
    out = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.card
def test_the_control_is_not_correct_and_the_port_is(card):
    cell = ["--workload", "ecdsa_p256_k17.pool", "--seconds", "10"]
    [control] = _results(["bench_port/control.py", *cell, "--seeds", "2147483659"])
    assert not control["correct"] and control["checks"]["proofs_rejected"]["value"] > 0
    [sound] = _results(["bench_port/run.py", *cell, "--seed", "2147483659", "--trace", "0"])
    assert sound["correct"]
