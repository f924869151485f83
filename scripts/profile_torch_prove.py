#!/usr/bin/env python3
"""Where a k=17 ECDSA proof of the PyTorch/CUDA port spends its time.

    python3 scripts/profile_torch_prove.py [--proofs 5] [--routes v3,serial,v1]
                                           [--out build/profile_prove.txt]

Keys the default circuit (on the v3 route), then for each commit route of
--routes (v3, the default pipeline; serial, ops/msm.py with the fused EC
add; v1, ops/msm_v1.py), set through plonk/keygen.MSM_ENGINE: proves once
to warm up, times --proofs more proofs (median and quartiles of the wall
time, each ending in a device synchronise), then proves once more under
torch.profiler (CPU and CUDA activities). From the profiled proof it
prints the summed time of the kernels on the device, its share of the
proof's wall time (the device's busy share; the rest is idle), the launch
count, the per-phase spans with the kernels launched and the device time
inside each, the port's own kernel launches, the card's name and power
limit, the kernels with the most device time and the roofline of the
profiled proof's phases (utils/roofline.py: time, work, bound and the
fraction of the bound each phase reached), one JSON object a route, and
writes each route's operator table to --out (the route's name added before
the suffix for routes other than v3). The phase spans need WH2_TRACE, which
this script sets unless it is set already: every proof, timed ones too,
fences its phases. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _det_rng(seed: bytes):
    ctr = [0]

    def rng(nbytes: int) -> bytes:
        ctr[0] += 1
        return hashlib.blake2b(seed + ctr[0].to_bytes(8, "little"),
                               digest_size=nbytes).digest()

    return rng


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile_prove.txt")
    ap.add_argument("--proofs", type=int, default=5)
    ap.add_argument("--routes", default="v3")
    args = ap.parse_args()
    os.environ.setdefault("WH2_TRACE", "1")  # the spans that the phases are read from
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import (
        CircuitParams, ECDSACircuit, ECDSAInputs)
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import msm_v1 as MV
    from webauthn_halo2_tpu_torch.ops import ntt as N
    from webauthn_halo2_tpu_torch.plonk import keygen as KG
    from webauthn_halo2_tpu_torch.plonk import prover as PR
    from webauthn_halo2_tpu_torch.utils import roofline as RL

    class PhaseSpan(PR._Span):
        """The prover's phase span, also a profiler range, closed after the
        span's closing device fence."""

        def __enter__(self):
            super().__enter__()
            self.rf = torch.profiler.record_function("phase: " + self.name)
            self.rf.__enter__()
            return self

        def __exit__(self, *a):
            super().__exit__(*a)
            self.rf.__exit__(*a)

    PR._Span = PhaseSpan

    dev = torch.device("cuda")
    K.build_all()
    params = CircuitParams()
    inp = ECDSAInputs.dummy()

    def le(v):
        return int(v).to_bytes(32, "little")

    args_ = (le(inp.r), le(inp.s), le(inp.pk[0]), le(inp.pk[1]), le(inp.msghash))
    advice, _ = api._witness(ECDSACircuit(params), *args_)
    model = RL.proof_work_model(api.proving_key(params, device=dev), "shplonk", advice)

    def measure(route, args_):
        """Warm-up, --proofs timed proofs and one profiled proof on the
        commit engine set for `route`."""
        api.generate_proof(*args_, params=params, device=dev, rng=_det_rng(b"warm"))
        walls = []
        for i in range(args.proofs):
            t0 = time.time()
            api.generate_proof(*args_, params=params, device=dev,
                               rng=_det_rng(b"run%d" % i))
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        q = statistics.quantiles(walls, n=4) if len(walls) > 1 else walls * 3

        for d in (M.LAUNCHES, N.LAUNCHES, MF.LAUNCHES, E.LAUNCHES):
            for key in d:
                d[key] = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            api.generate_proof(*args_, params=params, device=dev, rng=_det_rng(b"prof"))
            torch.cuda.synchronize()
            wall = time.time() - t0
        # the phase ranges also show on the device as annotations: not kernels
        events = prof.key_averages()
        kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                          and not e.key.startswith("phase: ")),
                         key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in kernels)
        # each device kernel goes to the phase whose host range holds its start
        # (the spans fence the device at both ends)
        phases = {}
        raw = prof.events()
        dev_events = [e for e in raw if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("phase: ")]
        for ph in (e for e in raw if e.name.startswith("phase: ")
                   and e.device_type == DeviceType.CPU):
            t0_, t1_ = ph.time_range.start, ph.time_range.end
            inside = [e for e in dev_events if t0_ <= e.time_range.start <= t1_]
            phases[ph.name[len("phase: "):]] = {
                "wall_s": (t1_ - t0_) / 1e6, "kernel_launches": len(inside),
                "device_kernel_s": sum(e.time_range.elapsed_us() for e in inside) / 1e6}
        root, ext = os.path.splitext(args.out)
        out = args.out if route == "v3" else f"{root}_{route}{ext}"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(events.table(sort_by="self_device_time_total", row_limit=60))
        roofline = RL.report(PR.LAST_SPANS, model)
        print(f"[{route}] roofline of the profiled proof's phases:\n"
              + RL.format_report(roofline), flush=True)
        return {
            "prove_wall_s_runs": walls,
            "prove_wall_s_median": statistics.median(walls),
            "prove_wall_s_quartiles": [q[0], q[2]],
            "profiled_prove_wall_s": wall,
            "device_kernel_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "port_kernel_launches": {**M.LAUNCHES, **N.LAUNCHES, **MF.LAUNCHES,
                                     **E.LAUNCHES},
            "spans_s": dict(PR.LAST_SPANS),
            "roofline": roofline,
            "phases_under_profiler": phases,
            "top_kernels_by_device_time": [
                {"name": e.key[:70], "device_ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in kernels[:12]],
        }

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    engines = {"v3": MF, "serial": MS, "v1": MV}
    for route in args.routes.split(","):
        KG.MSM_ENGINE = engines[route]
        try:
            report = measure(route, args_)
        finally:
            KG.MSM_ENGINE = MF
        print(json.dumps({"route": route, "card": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi, **report}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
