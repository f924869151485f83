"""A checkout for the harness's CPU runs: the toy system's configuration,
a traffic mix and a BENCHMARK.json naming them, beside the benchmark's own
metric files."""
from __future__ import annotations

import json
import os
import shutil

from toy_system import PARAMS, ToySystem

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def toy_root(tmp: str, ranks: int = 1, signatures: str = "in_domain") -> str:
    """A directory that the harness can run `toy.pool` from."""
    from bp import reference as ref

    system = ToySystem({})
    fixed, advice, copies = system.layout()
    circ = ref.Circuit(PARAMS["degree"], PARAMS["num_advice"], PARAMS["num_lookup_advice"],
                       PARAMS["lookup_bits"])
    cfg = dict(name="toy", circuit=dict(PARAMS), srs_seed="dev", inputs=system.inputs(),
               layout_digest=ref.layout_digest(circ, fixed, advice, copies))
    os.makedirs(os.path.join(tmp, "bench_port", "traffic"), exist_ok=True)
    with open(os.path.join(tmp, "toy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tmp, "bench_port", "traffic", "toy_pool.json"), "w") as f:
        json.dump(dict(loop="closed", ranks_per_card=ranks, requests_per_call=2,
                       signatures=signatures), f)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(tmp, "bench_port", "metrics"),
                    dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(name="toy", source="test", file="toy.json", reduced=[], why="test")]
    bench["workloads"] = [dict(name="toy.pool", config="toy", traffic="toy_pool", chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
