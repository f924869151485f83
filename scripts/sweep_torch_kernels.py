#!/usr/bin/env python3
"""Measurements behind the design of the montmul and combine kernels of the
PyTorch/CUDA port, on one CUDA card, that chip_smoke.py does not make.

    python3 scripts/sweep_torch_kernels.py [--parent DIR] [--grid 1024:128,1024:256]
                                           [--rounds 5] [--out build/sweep_kernels.json]

1. SASS of the montmul kernel: `cuobjdump -sass` of the built library, for
   each instantiation its instructions by opcode and per multiply. With
   --parent (the root of an earlier tree of the repository whose kernels
   were built there, under build/kernels), the same for its library.
2. With --parent, that tree's montmul kernel against this one at (8, 2^19),
   warm (the same operands every call) and cold (four operand sets in
   turn, 192 MB), in turns (parent, this, this, parent), from CUDA graph
   replays, with the SM clock and power draw beside each time.
3. The combine's chunking on the proof's own commit batches: keys the
   default circuit, proves chip_smoke's signature once on the v3 route
   recording each commit batch (chip_smoke's recording hook), builds each
   batch's buckets with chip_smoke's `_msm_stages` (which checks the
   combine against combine_plain), then times both launches of the
   combine, and each apart, for every (G, P) of --grid (G chunks a row, P
   row threads), --rounds times in turns, the order reversed every other
   round. Every configuration's window sums equal the built default's as
   affine points.
Prints one JSON line per part and writes them all to --out. Needs one card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")


def sass_counts(lib: Path) -> dict:
    """Per montmul kernel instantiation of `lib`: instructions in all (one
    multiply each), by opcode, with the integer multiply-adds (IMAD, not
    IMAD.MOV) apart."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name, ops = {}, None, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name, ops = m.group(1), collections.Counter()
            if "montmul_kernel" in name:
                out[name] = ops
        elif name and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)):
            ops[m.group(1)] += 1
    return {name: dict(instructions=sum(ops.values()),
                       imad=sum(v for k, v in ops.items() if k.startswith("IMAD")
                                and not k.startswith("IMAD.MOV")),
                       by_opcode=dict(ops.most_common()))
            for name, ops in out.items()}


def montmul_turns(parent: Path, dev) -> dict:
    """The parent tree's montmul kernel and this tree's at (8, 2^19), warm
    and cold, in turns."""
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.ops import modops as M

    libs = sorted((parent / "build" / "kernels").glob("libmontmul_*.so"))
    if not libs:
        raise SystemExit(f"no built montmul library under {parent}/build/kernels")
    old = ctypes.CDLL(str(libs[0]))
    old.wh2_montmul.argtypes = K._SIGNATURES["wh2_montmul"]
    old.wh2_montmul.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(19)
    n = 1 << 19
    sets = [(CS._rand_words(FR_SPEC, (n,), gen, dev), CS._rand_words(FR_SPEC, (n,), gen, dev))
            for _ in range(4)]

    def parent_call(a, b):
        out = torch.empty_like(a)
        K.check(old.wh2_montmul(a.data_ptr(), n, 0, b.data_ptr(), n, 0, out.data_ptr(), n,
                                K.modulus_words(FR_SPEC), FR_SPEC.n0, K.stream_ptr(dev)),
                "parent montmul")
        return out

    calls = {"parent": parent_call, "this": lambda a, b: M.montmul_cuda(FR_SPEC, a, b)}
    a, b = sets[0]
    if not torch.equal(calls["parent"](a, b), calls["this"](a, b)):
        raise SystemExit("the parent's montmul and this tree's disagree")
    rows = []
    for who in ("parent", "this", "this", "parent"):
        fn = calls[who]
        turn = [0]

        def cold():
            x, y = sets[turn[0] % 4]
            turn[0] += 1
            return fn(x, y)

        warm = CS._clocks_during(lambda: fn(a, b))
        cold_t = CS._clocks_during(cold)
        rows.append(dict(tree=who, warm_ms=warm[0], warm_sm_mhz=warm[1], warm_power_w=warm[2],
                         cold_ms=cold_t[0], cold_sm_mhz=cold_t[1], cold_power_w=cold_t[2]))
    return dict(shape="(8, 2^19)", bound_ms=CS._bound_ms(
        dict(bytes=3 * CS.ELEM_BYTES * n, ops=CS.IMAD_PER_MONTMUL * n))[0], turns=rows)


def proof_batches(dev) -> list:
    """Keygen and one v3 proof of the default circuit on chip_smoke's
    signature; returns the proof's commit batches (bases, scalars)."""
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams

    params = CircuitParams()
    api.proving_key(params, device=dev)
    batches = []
    stop_recording = CS._record_window_sums(batches)
    try:
        api.generate_proof(*CS._signed_message(), params=params, device=dev,
                           rng=CS._det_rng(b"chip_smoke"))
    finally:
        stop_recording()
    return batches


def combine_grid(dev, grid: list, rounds: int) -> dict:
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.ops import msm_fused as MF

    curve = E.BN254_CURVE
    f = curve.field
    lib = K.lib("combine")
    consts = (K.modulus_words(f), f.n0, K.one_words(f), K.stream_ptr(dev))
    n = 1 << 17
    c = MS._default_c(n)
    nb = 1 << c
    results = []
    for i, (points, scalars) in enumerate(proof_batches(dev)):
        stages, buckets, wsums = CS._msm_stages(curve, points, scalars, c, MF.lanes_for(n),
                                                timed=True, check=False, iters=1,
                                                check_combine=True)
        if stages["msm_combine"]["err"]:
            raise SystemExit(f"the combine disagrees with combine_plain on batch {i}")
        want = E.to_affine_ints(curve, wsums)
        R = buckets.x.shape[1]
        timers = {}
        for G, P in grid:
            out = E.JPoint(*(torch.empty((8, R), dtype=torch.int32, device=dev)
                             for _ in range(3)))
            part = torch.empty((6, 8, R * G), dtype=torch.int32, device=dev)

            def chunks(G=G, part=part):
                K.check(lib.wh2_msm_combine_chunks(*(t.data_ptr() for t in buckets),
                                                   part.data_ptr(), R, nb, G, *consts), "chunks")

            def rows(G=G, P=P, part=part, out=out):
                K.check(lib.wh2_msm_combine_rows(part.data_ptr(), *(t.data_ptr() for t in out),
                                                 R, nb, G, P, *consts), "rows")

            chunks()
            rows()
            if E.to_affine_ints(curve, out) != want:
                raise SystemExit(f"G={G}, P={P} gives other window sums on batch {i}")
            timers[(G, P)] = (chunks, rows)
        times = {g: dict(ms=[], chunks_ms=[], rows_ms=[]) for g in grid}
        for rnd in range(rounds):
            for g in (grid if rnd % 2 == 0 else grid[::-1]):
                chunks, rows = timers[g]
                times[g]["chunks_ms"].append(CS._events_ms(chunks, 3))
                times[g]["rows_ms"].append(CS._events_ms(rows, 3))
                times[g]["ms"].append(CS._events_ms(lambda: (chunks(), rows()), 5))
        row = dict(batch=i, rows=R, bound_ms=CS._bound_ms(stages["msm_combine"])[0],
                   configs=[dict(G=G, P=P, **times[(G, P)]) for G, P in grid])
        results.append(row)
        print(json.dumps(row), flush=True)

    def median(vals):
        return sorted(vals)[len(vals) // 2]

    proof = {f"{G}:{P}": sum(median(x["ms"]) for r in results for x in r["configs"]
                             if (x["G"], x["P"]) == (G, P)) for G, P in grid}
    return dict(batches=results, proof_median_ms=proof,
                proof_bound_ms=sum(r["bound_ms"] for r in results))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--grid", default="512:256,1024:128,1024:256,2048:128,2048:256")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/sweep_kernels.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from webauthn_halo2_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    t0 = time.time()
    K.build_all()
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    report["sass"] = {"this": sass_counts(K._so_path("montmul"))}
    if args.parent:
        libs = sorted((args.parent / "build" / "kernels").glob("libmontmul_*.so"))
        report["sass"]["parent"] = sass_counts(libs[0])
    print(json.dumps({"sass": report["sass"]}), flush=True)
    if args.parent:
        report["montmul_turns"] = montmul_turns(args.parent, dev)
        print(json.dumps({"montmul_turns": report["montmul_turns"]}), flush=True)
    grid = [tuple(int(v) for v in g.split(":")) for g in args.grid.split(",")]
    report["combine"] = combine_grid(dev, grid, args.rounds)
    print(json.dumps({"combine_proof_median_ms": report["combine"]["proof_median_ms"],
                      "proof_bound_ms": report["combine"]["proof_bound_ms"]}), flush=True)
    report["seconds"] = time.time() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(report["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
