"""The port's benchmark: one cell of BENCHMARK.json, run once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration (its file of
circuit parameters) and a traffic mix (bench_port/traffic/<name>.json);
each metric is read by bench_port/metrics/<name>.py. The pool's ranks
(bp/pool.py) prove on the card; this process only spawns them, reads their
records and then checks what they returned against the plain reference
(bp/reference.py). The last line of standard output is the result, as JSON.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(root: str, workload: str) -> tuple:
    """(cell, configuration entry, configuration file, traffic, metrics) of a
    workload named in root/BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "bench_port", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def of_cell(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return cell, cfg, traffic, of_cell(bench["end_to_end"]), of_cell(bench["per_layer"])


def read_metric(root: str, name: str, run: dict):
    path = os.path.join(root, "bench_port", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def cache_env(root: str) -> dict:
    """Every key, SRS and kernel cache inside the checkout, at fixed paths."""
    b = os.path.join(root, "build", "bench_port")
    return dict(WH2_KEY_DIR=os.path.join(b, "keys"), WH2_SRS_DIR=os.path.join(b, "srs"),
                TRITON_CACHE_DIR=os.path.join(b, "triton"),
                TORCH_EXTENSIONS_DIR=os.path.join(b, "torch_extensions"), USE_FLAX="0")


def warm_start(env: dict, k: int, seed: bytes) -> bool:
    """Whether a key and an SRS file of degree k are there already (then
    every rank loads them at once; else rank 0 makes them first)."""
    return bool(glob.glob(os.path.join(env["WH2_KEY_DIR"], f"pk_k{k}_*.npz"))
                and glob.glob(os.path.join(env["WH2_SRS_DIR"], f"srs_bn254_k{k}_{seed.hex()}*.npz")))


def check(run: dict, cfg: dict, system) -> dict:
    """The reference's numbers, each with its limit (every one exact: 0).
    The ranks checked their own witnesses (bp/pool.check_witnesses); here
    the layout, the verifying key, every proof, and every failed call: a
    call may fail only where one of its signatures lies outside the
    circuit's domain (bp/reference.in_domain), which only a "uniform"
    traffic mix sends, with the ValueError of the program's witness, and
    its requests then count as failed, not returned."""
    from bp import reference as ref
    from bp.pool import traffic_request

    c = cfg["circuit"]
    circ = ref.Circuit(c["degree"], c["num_advice"], c["num_lookup_advice"], c["lookup_bits"])
    fixed, advice, copies = system.layout()
    ranks = run["ranks"]
    live = [r for r in ranks if r]
    digests = [ref.layout_digest(circ, fixed, advice, copies)]
    digests += [r["witness_check"]["layout_digest"] for r in live]
    tau = ref.derive_tau(cfg["srs_seed"].encode())
    vk = ref.verifying_key(circ, fixed, copies, tau)
    unexpected = rejected = missing = proved = 0
    seen = set()
    for r in live:
        for call in r["calls"]:
            if call["error"]:
                reqs = [traffic_request(run["seed"], f"rank {r['rank']}", i, run["signatures"])[0]
                        for i in call["idx"]]
                if call["error"][0] != "ValueError" or all(ref.in_domain(q) for q in reqs):
                    unexpected += len(call["idx"])
                continue
            proved += sum(1 for p in call["proofs"] if p)
            for p in call["proofs"]:
                if not p or p in seen:
                    missing += 1
                    continue
                seen.add(p)
                rejected += int(not ref.verify(vk, p, tau))
    return {
        "layout_mismatch": sum(d != cfg["layout_digest"] for d in digests),
        "vk_mismatch": sum(ref.vk_mismatches(vk, *r["vk"]) for r in live),
        "witness_faults": sum(r["witness_check"]["faults"] for r in live),
        "witnesses_unchecked": proved - sum(r["witness_check"]["checked"] for r in live),
        "proofs_rejected": rejected,
        "proofs_missing": missing,
        "unexpected_errors": unexpected,
        "ranks_missing": sum(1 for r in ranks if not r or not r["calls"]),
    }


def main(argv=None, root=None, device="cuda", system="bp.system:EcdsaSystem",
         fault=None, ranks_per_card=None) -> int:
    """One run; the exit code. `device`, `system` and `fault` are for the
    benchmark's own tests and its control (control.py), `ranks_per_card`
    for the sweep (sweep.py) that chose the traffic's: the command line
    runs the card and the port, unbroken, as the cell's files say."""
    global T_START
    start, T_START = T_START, None  # a second run in one process starts now
    start = start or time.time()
    args = parse(argv)
    root = os.path.abspath(root or os.getcwd())
    cell, cfg, traffic, e2e, per_layer = load_cell(root, args.workload)
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s): found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, root)  # the program, for the ranks and the layout
    env = cache_env(root)
    os.environ.update(env)
    for name in ("WH2_TRACE", "WH2_SHARDED"):
        os.environ.pop(name, None)
    from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks

    from bp.pool import banned_modules, load_system, rank_main
    from bp.stats import returned_latencies

    cards, per_card = cell["chips"], ranks_per_card or traffic["ranks_per_card"]
    k = cfg["circuit"]["degree"]
    job = dict(system=system, params=cfg["circuit"], inputs=cfg["inputs"], cards=cards,
               per_call=traffic["requests_per_call"], signatures=traffic["signatures"],
               seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
               warm=warm_start(env, k, cfg["srs_seed"].encode()), fault=fault)
    results = run_ranks(rank_main, per_card * cards, os.path.join(root, "build", "bench_port", "ranks"),
                        backend="gloo", args=(job,), timeout=900.0)
    live = [r for r in results if r]
    t0, t_end = live[0]["t0"], live[0]["t_end"]
    run = dict(ranks=results, t0=t0, t_end=t_end, seconds=args.seconds, setup_s=t0 - start,
               cards=cards, seed=args.seed, signatures=traffic["signatures"])
    traced = [r["trace"] for r in live if r.get("trace")]
    if traced:
        run["busy_s"] = sum(t["busy_s"] for t in traced) / cards
    metrics = {}
    for m in (per_layer if args.trace else e2e):
        v = read_metric(root, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_ranks = time.time()
    checks = check(run, cfg, load_system(job))
    print(f"timing: set-up {t0 - start:.1f} s, window {args.seconds} s, then the ranks "
          f"{t_ranks - t_end:.1f} s, the reference {time.time() - t_ranks:.1f} s",
          file=sys.stderr)
    banned = sorted(set(banned_modules()).union(*(r["banned_modules"] for r in live)))
    if banned:
        print(f"the run loaded JAX or the JAX package: {', '.join(banned)}", file=sys.stderr)
        return 3
    in_window = [c for r in live for c in r["calls"] if c["t_call"] < t_end]
    attempted = sum(len(c["proofs"]) for c in in_window)
    failed = sum(len(c["proofs"]) for c in in_window if c["error"])
    again = sum(c["again"] for c in in_window)
    for r in live:
        lat = " ".join(f"{c['t_ret'] - c['t_call']:.2f}" for c in r["calls"])
        print(f"rank {r['rank']} calls (s): {lat}", file=sys.stderr)
    returned = len(returned_latencies(run))
    calls_back = sum(1 for c in in_window if c["t_ret"] <= t_end and any(c["proofs"]))
    print(f"traffic: {attempted} requests in the window, {failed} failed, {returned} returned "
          f"inside it by {calls_back} calls (pool_latency_p90_s's requests; one latency a call); "
          f"{again} signatures outside the circuit's domain drawn again ({traffic['signatures']})",
          file=sys.stderr)
    for r in live:
        wc = r["witness_check"]
        print(f"rank {r['rank']}: {wc['checked']} witnesses checked in {wc['seconds']:.1f} s",
              file=sys.stderr)
        for c in r["calls"]:
            if c["error"]:
                print(f"rank {r['rank']} requests {c['idx']}: {': '.join(c['error'])}",
                      file=sys.stderr)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": live[0].get("device_name", device), "count": cards,
           "memory_peak_bytes": max((r.get("memory_used_peak", 0) for r in live), default=0)}
    result = dict(correct=all(v <= 0 for v in checks.values()), attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if traced:
        dev.update(busy_s=run["busy_s"], window_s=args.seconds)
        ops: dict = {}
        for t in traced:
            for name, s in t["top_ops"]:
                ops[name] = ops.get(name, 0.0) + s
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [["no kernel on the card (the ranks' host work)",
                           args.seconds - run["busy_s"]]]}
        for t in traced:
            first = "none" if t["first_start"] is None else f"t0{t['first_start'] - t0:+.3f} s"
            print(f"trace: rank kernels {t['kernels']}, first kernel at {first}, "
                  f"commit {t['commit']}, ntt {t['ntt']}", file=sys.stderr)
    result["checks"] = {name: {"value": v, "limit": 0} for name, v in checks.items()}
    for name, v in checks.items():
        print(f"check {name}: {v} (limit 0)", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
