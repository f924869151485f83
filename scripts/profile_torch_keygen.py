#!/usr/bin/env python3
"""Where the start-up of the PyTorch/CUDA port spends its time, step by step.

    python3 scripts/profile_torch_keygen.py [--degree 17] [--device cuda]
        [--key-dir DIR] [--srs-dir DIR] [--signature HEX]
        [--rng-seed profile] [--out build/profile_keygen.json]

The port of the JAX package's scripts/profile_keygen.py. At --degree
(default $WH2_BENCH_K, else 17; the production CircuitParams at 17,
auto_params(k) elsewhere) it runs, in the JAX script's order:
  1. srs: get_srs, from a file in --srs-dir ($WH2_SRS_DIR when not given,
     else the committed and build/srs/ files) or generated there, saying
     which;
  2. circuit build: the ECDSA-P256 circuit's synthesis on the dummy inputs;
  3. keygen: the circuit's digest, which names the key file, then keygen
     (its steps' spans under WH2_TRACE, which this script sets unless it
     is set), skipped when the key file is already in --key-dir;
  4. key file: the key saved to --key-dir ($WH2_KEY_DIR when not given,
     else a new directory under build/, removed at the end) when it was
     made, else loaded from it. Steps 3 and 4 are the work of
     plonk/pk_cache.keygen_cached, which api.proving_key runs with
     WH2_KEY_DIR set, split in two: steps 1-4 are what a process pays
     from its start to a key ready to prove;
  5. witness of one signature (--signature, r s x y msghash as 32-byte
     little-endian words in hex, else one drawn from a fixed seed);
  6. proof 1 (cold: the first proof of the process), with the key of
     step 4;
  7. proof 2, with the same rng (--rng-seed) and, when step 3 made the
     key, the key loaded back from its file (a check, timed on a line of
     its own and in no step): the same bytes as proof 1, else the run
     fails;
  8. verification of proof 2 (the native host verifier).
On a card the kernel and host libraries are built (nvcc, g++) or loaded
before step 1, and their seconds recorded apart. For each step: wall
seconds; on a card, the summed time of the kernels on the device and
their launches (torch.profiler's CUDA activity: the device events'
durations, the sum that scripts/profile_torch_prove.py takes; the wall
time includes the profiler's cost, about 0.4 s a proof) and the peak
device memory; the process's peak host memory so far. The record also
holds the port's kernel launches over the eight steps (the counters of
ops/modops, ntt, msm_fused, ec and mxu_mod). The table goes to stderr,
the whole record as JSON to --out.
`profile_startup` runs the steps for any circuit (the tests run it on a toy
circuit on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("srs", "circuit build", "keygen", "key file", "witness", "proof 1 (cold)",
         "proof 2", "verify")


def port_launches() -> dict:
    """The port's kernel launch counters (rows 1-6, 8, 9 of the kernel
    table), as chip_smoke.py reads them."""
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF
    from webauthn_halo2_tpu_torch.ops import mxu_mod as X
    from webauthn_halo2_tpu_torch.ops import ntt as N

    return {**M.LAUNCHES, **N.LAUNCHES, **MF.LAUNCHES, **E.LAUNCHES, **X.LAUNCHES}


class _Step:
    """One step's wall seconds, and on a card its kernels' device seconds
    and launches (torch.profiler) and its peak device memory; the process's
    peak host memory so far."""

    def __init__(self, name: str, dev, record: list):
        self.name, self.dev, self.record = name, dev, record
        self.row = {"step": name}

    def __enter__(self):
        import torch

        self.prof = None
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.time()
        return self.row

    def __exit__(self, *exc):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.row["wall_s"] = time.time() - self.t0
        self.row.update(device_s=None, launches=None, peak_gb=None)
        if self.prof is not None:
            from torch.autograd import DeviceType

            self.prof.__exit__(*exc)
            if exc[0] is None:
                # the raw device events: key_averages() would build every
                # event's tree first, some 20 s over SRS generation's 96k
                # launches
                kernels = [e for e in self.prof.profiler.kineto_results.events()
                           if e.device_type() == DeviceType.CUDA
                           and not e.is_user_annotation()]
                self.row.update(
                    device_s=sum(e.duration_ns() for e in kernels) / 1e9,
                    launches=len(kernels),
                    peak_gb=torch.cuda.max_memory_allocated(self.dev) / 1e9)
        self.row["host_peak_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        self.record.append(self.row)
        return False


def profile_startup(k: int, build, witness, key_dir: str, *, srs_dir: str | None = None,
                    device=None, rng_seed: bytes = b"profile", log=None) -> dict:
    """Steps 1-8 for one circuit of degree k: `build()` gives (cs, fixed,
    advice, copies) of its synthesis, `witness()` gives (advice, instances)
    of the inputs to prove. The key file lives in `key_dir`; the dev SRS's
    files where plonk/srs.srs_paths(k, cache_dir=srs_dir) says. Returns the
    record: each step's row, where the SRS and the key came from, the key
    file, the vk's transcript_repr, the keygen spans and the proof; raises
    RuntimeError when the proofs differ or the proof does not verify."""
    from webauthn_halo2_tpu_torch.device import resolve
    from webauthn_halo2_tpu_torch.parallel.batch import seeded_rng
    from webauthn_halo2_tpu_torch.plonk import pk_cache as PC
    from webauthn_halo2_tpu_torch.plonk import srs as S
    from webauthn_halo2_tpu_torch.plonk.keygen import keygen
    from webauthn_halo2_tpu_torch.plonk.prover import create_proof
    from webauthn_halo2_tpu_torch.plonk.verifier import verify_proof

    dev = resolve(device)
    steps: list = []
    out = {"k": k, "device": str(dev), "steps": steps}
    if dev.type == "cuda":
        # before the steps: the kernel and host libraries' build (nvcc, g++)
        # or load, and the profiler's own start-up
        from torch.profiler import ProfilerActivity, profile

        from webauthn_halo2_tpu_torch.ops import kernels as KN
        from webauthn_halo2_tpu_torch.utils import host_build as HB

        t0 = time.time()
        KN.build_all()
        HB.build_all()
        out.update(libraries_s=time.time() - t0, nvcc_s=dict(KN.BUILD_SECONDS))
        with profile(activities=[ProfilerActivity.CUDA]):
            pass
    launches_before = port_launches()

    def step(name):
        return _Step(name, dev, steps)

    in_memory = (k, b"dev", str(dev)) in S._SRS_MEM_CACHE
    paths = S.srs_paths(k, cache_dir=srs_dir)
    files = [p for p in paths if os.path.exists(p)]
    with step("srs"):
        srs = S.get_srs(k, cache_dir=srs_dir, device=dev)
    out["srs"] = "in memory" if in_memory else "loaded" if files else "generated"
    out["srs_file"] = files[0] if files else paths[1]
    with step("circuit build"):
        cs, fixed, _advice, copies = build()
    made = None
    with step("keygen") as row:
        t0 = time.time()
        path = PC.pk_file(key_dir, srs, cs, fixed, copies)  # the circuit's digest
        row["digest_s"] = time.time() - t0
        if os.path.exists(path):
            row["skipped"] = "the key file is there"
        else:
            made = keygen(srs, cs, fixed, copies, device=dev)
    out["key"] = "loaded" if made is None else "made"
    out["keygen_spans"] = dict(made.spans) if made is not None else {}
    with step("key file") as row:
        t0 = time.time()
        if made is None:
            pk = PC.load_pk(path, srs, cs, device=dev)
            row["load_s"] = time.time() - t0
        else:
            os.makedirs(key_dir, exist_ok=True)
            PC.save_pk(path, made)
            row["save_s"] = time.time() - t0
            pk = made
    out.update(key_file=path, key_file_bytes=os.path.getsize(path),
               vk_transcript_repr=hex(pk.vk.transcript_repr))
    loaded = pk
    if made is not None:  # the check of the saved file, after the start-up
        with _Step("key reload (check)", dev, []) as row:
            loaded = PC.load_pk(path, srs, cs, device=dev)
        out["reload"] = row
        if made.vk.transcript_repr != loaded.vk.transcript_repr:
            raise RuntimeError("the key loaded from its file has another vk than the key made")
    with step("witness"):
        advice, instances = witness()
    with step("proof 1 (cold)"):
        proof = create_proof(pk, advice, instances, rng=seeded_rng(rng_seed), device=dev)
    with step("proof 2"):
        again = create_proof(loaded, advice, instances, rng=seeded_rng(rng_seed), device=dev)
    if again != proof:
        raise RuntimeError("the proof from the key loaded from its file differs from "
                           "the proof from the key " + out["key"])
    with step("verify") as row:
        row["ok"] = verify_proof(loaded.vk, srs, again, instances)
    if not row["ok"]:
        raise RuntimeError("the proof did not verify")
    out.update(proof_hex=again.hex(), proof_bytes=len(again),
               startup_s=sum(r["wall_s"] for r in steps[:4]),
               kernel_launches={name: n - launches_before[name]
                                for name, n in port_launches().items()})
    if log:
        log(format_table(out))
    return out


def format_table(record: dict) -> str:
    """The steps of a record as a text table."""
    def num(v, width: int, fmt: str) -> str:
        return ("-" if v is None else format(v, fmt)).rjust(width)

    built = ("" if "libraries_s" not in record else
             f"; kernel and host libraries built or loaded first in "
             f"{record['libraries_s']:.3f} s")
    lines = [f"start-up at k={record['k']} on {record['device']}: SRS {record['srs']}, "
             f"key {record['key']}; start-up (steps 1-4) {record['startup_s']:.3f} s{built}",
             f"{'step':18s} {'wall s':>9s} {'device s':>9s} {'launches':>9s} "
             f"{'peak GB':>8s} {'host GB':>8s}"]

    def line(r: dict) -> str:
        return (f"{r['step']:18s} {r['wall_s']:9.3f} {num(r['device_s'], 9, '.4f')} "
                f"{num(r['launches'], 9, 'd')} {num(r['peak_gb'], 8, '.3f')} "
                f"{r['host_peak_gb']:8.3f}" + (f"  ({r['skipped']})" if "skipped" in r else ""))

    lines += [line(r) for r in record["steps"]]
    if "reload" in record:
        lines.append(line(record["reload"]) + "  (not start-up: proof 2's key)")
    return "\n".join(lines)


def _signature(args) -> tuple:
    """(r, s, (x, y), msghash) from --signature, else drawn from a fixed
    seed."""
    import random

    from webauthn_halo2_tpu_torch.fields.ref_curve import (P256_CURVE, ecdsa_keygen,
                                                           ecdsa_sign)

    if args.signature:
        raw = bytes.fromhex(args.signature)
        if len(raw) != 160:
            raise SystemExit("--signature takes 160 bytes: r s x y msghash, 32 LE bytes each")
        r, s, x, y, m = (int.from_bytes(raw[i:i + 32], "little") for i in range(0, 160, 32))
        return r, s, (x, y), m
    rnd = random.Random(17)

    class Draw:
        @staticmethod
        def randbelow(n):
            return rnd.randrange(n)

    sk, pub = ecdsa_keygen(rng=Draw)
    m = rnd.randrange(P256_CURVE.n)
    r, s = ecdsa_sign(m, sk, k=1 + rnd.randrange(P256_CURVE.n - 1))
    return r, s, pub, m


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--degree", type=int, default=int(os.environ.get("WH2_BENCH_K", "17")))
    ap.add_argument("--device", default=None, help="default: the current card")
    ap.add_argument("--key-dir", default=None)
    ap.add_argument("--srs-dir", default=None)
    ap.add_argument("--signature", default=None)
    ap.add_argument("--rng-seed", default="profile")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_keygen.json"))
    args = ap.parse_args(argv)
    os.environ.setdefault("WH2_TRACE", "1")  # keygen's spans

    import torch

    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import (
        CircuitParams, ECDSACircuit, ECDSAInputs, auto_params)
    from webauthn_halo2_tpu_torch.plonk import pk_cache as PC

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    k = args.degree
    params = CircuitParams() if k == CircuitParams().degree else auto_params(k)
    circuit = ECDSACircuit(params)
    r, s, pub, m = _signature(args)
    inputs = ECDSAInputs(r=r, s=s, msghash=m, pk=pub)
    key_dir = PC.key_dir(args.key_dir)
    scratch = None
    if key_dir is None:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        key_dir = scratch = tempfile.mkdtemp(prefix="profile_keys_",
                                             dir=os.path.join(ROOT, "build"))
    try:
        record = profile_startup(
            k, lambda: circuit.build(ECDSAInputs.dummy()),
            lambda: (circuit.witness(inputs), circuit.public_inputs(inputs)),
            key_dir, srs_dir=args.srs_dir, device=args.device,
            rng_seed=args.rng_seed.encode(), log=log)
    finally:
        if scratch:
            shutil.rmtree(scratch)
    if record["device"].startswith("cuda"):
        record["card"] = torch.cuda.get_device_name(record["device"])
        record["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    record["params"] = json.loads(params.to_json())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    log(f"record: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
