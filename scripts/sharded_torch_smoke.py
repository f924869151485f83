#!/usr/bin/env python3
"""Proving over ranks of torch.distributed on one host, one rank a card.

    python3 scripts/sharded_torch_smoke.py [--ranks 4] [--backend nccl]

Builds the kernels, keys and proves the ECDSA-P256 circuit at the default
CircuitParams (k=17) on cuda:0, the one-device reference, then spawns the
ranks (webauthn_halo2_tpu_torch/parallel/ranks.py; under NCCL rank r on
cuda:r), each running chip_smoke.py's phase-13 rank: the sharded
primitives at k=17 against one device, keygen and the proof with
WH2_SHARDED=1. Every rank's bytes must equal the one-device proof, rank 0
verifies it, every hooked call takes the sharded route, rows 1-6 launch
in every rank, and rank 0 holds each launch shape and commit batch of the
path against the plain versions (chip_smoke's `sharded_group`). Prints the cards' names and power limits, then, last, a
JSON line of the group's numbers. Fails without a card, and under NCCL
with fewer cards than ranks.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is false: this run needs cards")
    if args.backend == "nccl" and torch.cuda.device_count() < args.ranks:
        C.fail(f"NCCL takes one rank a card: {args.ranks} ranks, "
               f"{torch.cuda.device_count()} cards")
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    os.environ.setdefault("WH2_TRACE", "1")  # the ranks count ROUTES and COLLECTIVES
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.time()
    K.build_all()
    C.log(f"[build] kernels in {time.time() - t0:.1f}s")
    dev = torch.device("cuda", 0)
    params = CircuitParams()
    srs = get_srs(params.degree, device=dev)
    t0 = time.time()
    api.proving_key(params, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    t0 = time.time()
    proof = api.generate_proof(*C._signed_message(), params=params, device=dev,
                               rng=C._det_rng(b"chip_smoke"))
    prove_s = time.time() - t0
    C.log(f"[one device] keygen {keygen_s:.2f}s, proof {prove_s:.2f}s ({len(proof)} bytes)")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="sharded_torch_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        out = C.sharded_group(args.backend, args.ranks, run_dir, dev, srs, proof,
                              keygen_s, prove_s)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    out.pop("oracle")
    for card in cards:
        print(card, flush=True)
    print(json.dumps({"sharded": out, "cards": cards}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
