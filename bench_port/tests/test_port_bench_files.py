"""The benchmark's files and arithmetic, on the CPU: every configuration,
traffic mix and metric found by name; the window's rate and tail; the
frozen roofline against the program's; and what the harness imports."""
import ast
import json
import os
import random
import re

import pytest
import torch

from bp import roofline, stats

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_finds_its_files_by_name():
    b = _bench()
    assert b["command"] == ["python3", "bench_port/run.py"] and b["paths"] == ["bench_port"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and c["file"].startswith("bench_port/")
        for key in ("degree", "num_advice", "num_lookup_advice", "lookup_bits"):
            assert cfg[key] == cfg["circuit"][key]
    for w in b["workloads"]:
        assert w["config"] in configs and NAME.match(w["name"])
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"])
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        assert "def read(run)" in open(path).read()
    assert all(m["bound"] <= 0.25 for m in b["end_to_end"])
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2


@pytest.mark.parametrize("config", ["ecdsa_p256_k17", "ecdsa_p256_k19"])
def test_a_configuration_pins_the_programs_layout_and_input_cells(config):
    """The program's synthesis of the circuit has the configuration's layout
    digest, and a request's witness carries its inputs at the cells named."""
    from bp import plain, reference as ref
    from bp.system import EcdsaSystem

    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        cfg = json.load(f)
    c = cfg["circuit"]
    system = EcdsaSystem(c)
    fixed, advice, copies = system.layout()
    circ = ref.Circuit(c["degree"], c["num_advice"], c["num_lookup_advice"], c["lookup_bits"])
    assert ref.layout_digest(circ, fixed, advice, copies) == cfg["layout_digest"]
    req = plain.ecdsa_request(2 ** 35 + 1, "test", 0)
    adv, inst = system.witnesses([req])[0]()
    assert ref.witness_faults(circ, fixed, copies, adv, inst, cfg["inputs"], req) == 0
    other = plain.ecdsa_request(2 ** 35 + 1, "test", 1)
    assert ref.witness_faults(circ, fixed, copies, adv, inst, cfg["inputs"], other) == 15


def _run(calls, t_end=10.0):
    return dict(ranks=[dict(calls=calls)], t_end=t_end, seconds=10.0)


def _call(t_call, t_ret, proofs=(b"a", b"b")):
    return dict(t_call=t_call, t_ret=t_ret, proofs=list(proofs), error=None)


def _metric(name, run):
    import importlib.util

    spec = importlib.util.spec_from_file_location("m", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_the_rate_counts_every_proof_of_the_window_over_all_of_it():
    calls = [_call(0, 3), _call(3, 6), _call(6, 9.5), _call(9.5, 12), _call(0, 4, (b"c", None))]
    # 7 proofs back inside the window (the failed request not), and the call
    # running at the close for the 0.5 s of its 2.5 s inside the window
    assert _metric("proofs_per_s", _run(calls)) == pytest.approx((7 + 2 * 0.5 / 2.5) / 10)


def test_the_tail_is_over_every_request_and_not_over_chunks():
    random.seed(5)
    lat = [random.uniform(1, 9) for _ in range(40)]
    calls, t = [], 0.0
    for v in lat:
        calls.append(_call(t, t + v, (b"x",)))
    run = _run(calls, t_end=100.0)
    want = sorted(lat)[35] + (sorted(lat)[36] - sorted(lat)[35]) * 0.1
    assert _metric("pool_latency_p90_s", run) == pytest.approx(want)
    # not the mean of the p90 of two halves
    halves = [stats.percentile(lat[:20], 90), stats.percentile(lat[20:], 90)]
    assert _metric("pool_latency_p90_s", run) != pytest.approx(sum(halves) / 2)


def test_proof_equivalents_count_the_share_of_a_running_call():
    calls = [_call(0, 4), _call(8, 12)]
    assert stats.proof_equivalents(_run(calls)) == pytest.approx(2 + 2 * 0.5)


def test_the_frozen_roofline_equals_the_programs():
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops.msm import scalar_digits
    from webauthn_halo2_tpu_torch.utils import roofline as R

    for k in (6, 11, 17, 19, 21):
        assert roofline.ntt_work(3, k) == R.ntt_work(3, k)
        n = 1 << k
        assert roofline.window_bits(n) == __import__(
            "webauthn_halo2_tpu_torch.ops.msm", fromlist=["_default_c"])._default_c(n)
        assert roofline.msm_work(n, 4, 12345) == R.msm_work(n, 4, madds=12345)
    assert roofline.bound_s(R.msm_work(1 << 17, 8)) == pytest.approx(R.bound_ms(R.msm_work(1 << 17, 8))[0] / 1e3)
    rng = random.Random(3)
    vals = [rng.randrange(roofline.BN_R) for _ in range(50)] + [0, 1, 5, 1 << 88, (1 << 200) + 7]
    mont = torch.as_tensor(FR_SPEC.encode(vals))  # Montgomery words, (8, m)
    std = M.from_mont(FR_SPEC, mont)
    for n in (1 << 6, 1 << 17):
        want = int((scalar_digits(std, roofline.window_bits(n)) != 0).sum())
        assert roofline.nonzero_digits(mont, n) == want
    limbs = roofline.from_mont_limbs(mont)
    got = [sum(int(limbs[j][i]) << (16 * j) for j in range(16)) for i in range(len(vals))]
    assert got == vals


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_port():
    banned = {"jax", "jaxlib", "flax", "webauthn_halo2_tpu"}
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
                assert not tops & banned, f
    for f in ("reference.py", "plain.py", "roofline.py", "stats.py"):
        tops = {m.split(".")[0] for m in _imports(os.path.join(BENCH, "bp", f))}
        assert "webauthn_halo2_tpu_torch" not in tops, f
