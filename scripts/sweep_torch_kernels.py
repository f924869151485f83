#!/usr/bin/env python3
"""Measurements behind the design of the port's redesigned kernels (the
montmul, the combine, NTT stage A, the fused EC add and the int8 montmul),
on one CUDA card, that chip_smoke.py does not make.

    python3 scripts/sweep_torch_kernels.py [--parent DIR]
                                           [--parts sass,ntt,ec,montmul,combine,mxu]
                                           [--grid 1024:128,1024:256] [--rounds 5]
                                           [--out build/sweep_kernels.json]

1. sass: SASS of the montmul, stage-A, EC-add and int8-montmul kernels,
   `cuobjdump -sass` of the built libraries, for each instantiation its
   instructions by opcode and its loops (backward branches); for the int8
   montmul, from its loops' trip counts (MXU_LOOP_TRIPS), the warp
   instructions it issues an element. With --parent (the root of an
   earlier tree of the repository, e.g. a `git archive` unpacked into
   build/parent; its kernels are built there with its own build module
   when missing), the same for its libraries.
2. ntt: stage A at each launch shape of a k=17 proof (PROOF_NTT_LAUNCHES),
   for every schedule the kernel takes (block tiles of 2^9 to 2^12, in
   clusters of 1 to 4 blocks) and, with --parent, the parent's stage A at
   its 2^12 tile, in turns over --rounds rounds (the order reversed every
   other round), from CUDA graph replays: stage A alone and stage A with
   the stage-B launches that finish the transform. Every schedule's
   transform equals the first one's word for word.
3. ec: the fused EC add at the serial and v1 routes' shapes (EC_SHAPES,
   chip_smoke's operands: about a tenth infinite on each side), this tree's
   kernel and, with --parent, the parent's, in turns, from CUDA graph
   replays; each equal to `add_unsafe` word for word.
4. montmul (needs --parent): the parent's montmul kernel against this one
   at (8, 2^19), warm (the same operands every call) and cold (four
   operand sets in turn, 192 MB), in turns (parent, this, this, parent),
   from CUDA graph replays, with the SM clock and power draw beside each.
5. combine: the combine's chunking on the proof's own commit batches: keys
   the default circuit, proves chip_smoke's signature once on the v3 route
   recording each commit batch (chip_smoke's recording hook), builds each
   batch's buckets with chip_smoke's `_msm_stages` (which checks the
   combine against combine_plain), then times both launches of the
   combine, and each apart, for every (G, P) of --grid (G chunks a row, P
   row threads), --rounds times in turns. Every configuration's window
   sums equal the built default's as affine points.
6. mxu (needs --parent): the int8 tensor-core montmul, the parent tree's
   kernel (with the matrices and scalars its own ops/mxu_mod.py builds, in
   a process of its own; the earlier C entry, which takes the three
   matrices and four scalars) against this one, at (8, 2^19) in Fr and
   (8, 2^12) in Fq, each first checked equal to this
   tree's plain version and the montmul kernel, then --rounds rounds in
   turns from CUDA graph replays, with the SM clock and power draw read
   beside a last replay of each.
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

from webauthn_halo2_tpu_torch.utils import roofline as RL  # noqa: E402


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")


def sass_counts(lib: Path, kernel: str) -> dict:
    """Per instantiation of the kernels of `lib` whose name holds `kernel`:
    instructions in all, by opcode, with the integer multiply-adds (IMAD,
    not IMAD.MOV) apart, and its loops: each backward branch as [first
    instruction, branch] (indices into the kernel's instructions) with its
    body's instruction count, in address order."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name, fn = {}, None, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name, fn = m.group(1), dict(ops=collections.Counter(), addrs=[], branches=[])
            if kernel in name:
                out[name] = fn
        elif name and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                                      line)):
            addr = int(m.group(1), 16)
            fn["ops"][m.group(2)] += 1
            fn["addrs"].append(addr)
            if m.group(2).startswith("BRA") and (b := re.search(r"0x([0-9a-f]+)", m.group(3))):
                fn["branches"].append((addr, int(b.group(1), 16)))
    rows = {}
    for name, fn in out.items():
        ops, index = fn["ops"], {a: i for i, a in enumerate(fn["addrs"])}
        rows[name] = dict(instructions=sum(ops.values()),
                          imad=sum(v for k, v in ops.items() if k.startswith("IMAD")
                                   and not k.startswith("IMAD.MOV")),
                          by_opcode=dict(ops.most_common()),
                          loops=[dict(first=index[to], branch=index[at],
                                      body=index[at] - index[to] + 1)
                                 for at, to in fn["branches"] if to < at and to in index])
    return rows


# (source, kernel name) of each kernel whose SASS part 1 counts
SASS_KERNELS = (("montmul", "montmul_kernel"), ("ntt", "ntt_stage_a_kernel"),
                ("ec", "ec_add_unsafe_kernel"), ("mxu", "mxu_montmul_kernel"))


# Trip counts of the int8 montmul's inner loops (in address order) and the
# elements one pass of its tile loop takes: this tree's INTERP loop (8
# k-steps, unrolled by two) over 32 elements; the parent's (the kernel
# before its register chain) EVAL loop (16 n-tiles) for each prime, INTERP
# (16) and FOLD (8) over 16 elements
MXU_LOOP_TRIPS = {"this": ([4], 32), "parent": ([16, 16, 16, 8], 16)}


def mxu_issue_per_element(loops: list, trips: list, elements: int) -> dict | None:
    """Warp instructions one pass of the tile loop (the loop with the most
    loops inside it) issues, with every inner loop run its trip count, over
    the elements of a pass; None when the loops are not as expected."""
    outer = max(loops, key=lambda lp: sum(lp["first"] <= o["first"] and o["branch"] < lp["branch"]
                                          for o in loops if o is not lp))
    inner = [lp for lp in loops if lp is not outer
             and outer["first"] <= lp["first"] and lp["branch"] < outer["branch"]]
    if len(inner) != len(trips):
        return None
    issued = outer["body"] + sum((n - 1) * lp["body"] for lp, n in zip(inner, trips))
    return dict(tile_loop=outer["body"], inner=[lp["body"] for lp in inner], trips=trips,
                warp_instructions_a_pass=issued, elements_a_pass=elements,
                warp_instructions_an_element=issued / elements,
                thread_slots_an_element=32 * issued / elements)


def parent_library(parent: Path, name: str) -> Path:
    """The parent tree's built library `name`, built there (with the
    parent's own build module, in a process of its own) when missing."""
    libs = sorted((parent / "build" / "kernels").glob(f"lib{name}_*.so"))
    if not libs:
        subprocess.run([sys.executable, "-c",
                        "from webauthn_halo2_tpu_torch.ops import kernels as K; K.build_all()"],
                       cwd=parent, check=True)
        libs = sorted((parent / "build" / "kernels").glob(f"lib{name}_*.so"))
    if not libs:
        raise SystemExit(f"no built {name} library under {parent}/build/kernels")
    return libs[0]


def _load(path: Path, fn: str, argtypes: list) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def _median(vals):
    return sorted(vals)[len(vals) // 2]


def _turns(calls: dict, rounds: int, graph_calls: int, replays: int) -> dict:
    """ms a call of each of `calls`, from CUDA graph replays, `rounds` times
    in turns (the order reversed every other round): median and all."""
    import chip_smoke as CS

    names = list(calls)
    times = {k: [] for k in names}
    for rnd in range(rounds):
        for k in (names if rnd % 2 == 0 else names[::-1]):
            times[k].append(CS._graph_ms(calls[k], calls=graph_calls, replays=replays))
            torch.cuda.empty_cache()
    return {k: dict(ms=_median(v), runs=v) for k, v in times.items()}


# the NTT launch shapes of one k=17 proof on the v3 route, (B, k): launches
# (chip_smoke's recording, PERF.md)
PROOF_NTT_LAUNCHES = {(1, 17): 13, (1, 19): 1, (19, 17): 1, (19, 19): 1}


def ntt_turns(parent: Path | None, dev, rounds: int) -> dict:
    """Stage A (and stage A with the stage-B launches that finish the
    transform) at each proof launch shape, for every schedule the kernel
    takes with block tiles from 2^9 up, and the parent's at 2^12, in turns."""
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.ops import ntt as N

    old = None
    if parent:
        old = _load(parent_library(parent, "ntt"), "wh2_ntt_stage_a",
                    [K._P, K._P, K._P, K._LL, K._LL, K._LL, K._I, K._U32P, K._U32, K._P])
    gen = torch.Generator(device=dev).manual_seed(29)
    out = []
    for (B, k), launches in PROOF_NTT_LAUNCHES.items():
        n = 1 << k
        x = CS._rand_words(FR_SPEC, (B, n), gen, dev)
        tw = N._twiddles_dev(k, False, dev)
        cands = {}
        if old is not None:
            def parent_a(x=x, tw=tw, B=B, n=n):
                y = torch.empty_like(x)
                K.check(old.wh2_ntt_stage_a(x.data_ptr(), y.data_ptr(), tw.data_ptr(),
                                            tw.shape[1], B, n, 12, K.modulus_words(FR_SPEC),
                                            FR_SPEC.n0, K.stream_ptr(dev)), "parent stage A")
                return y
            cands["parent T=2^12"] = (parent_a, 12)
        for log_b in range(9, min(k, N.T_LOG_MAX) + 1):
            for cq in range(min(N.CLUSTER_LOG_MAX, k - log_b) + 1):
                cands[f"T=2^{log_b} C={1 << cq}"] = (
                    lambda x=x, tw=tw, lt=log_b + cq, cq=cq: N.stage_a(FR_SPEC, x, tw, lt, cq),
                    log_b + cq)

        def whole(fn, log_t, x=x, tw=tw, k=k):
            y = fn()
            for s in range(log_t, k):
                y = N.stage_b(FR_SPEC, y, tw, s)
            return y

        ref = None
        for name, (fn, log_t) in cands.items():
            y = whole(fn, log_t)
            if ref is None:
                ref = y
            elif not torch.equal(y, ref):
                raise SystemExit(f"stage A {name} gives another transform at (B={B}, 2^{k})")
        del ref, y
        a_only = _turns({name: fn for name, (fn, _) in cands.items()}, rounds, 10, 5)
        a_and_b = _turns({name: (lambda fn=fn, lt=lt: whole(fn, lt))
                          for name, (fn, lt) in cands.items()}, rounds, 10, 5)
        row = dict(shape=[B, k], launches=launches, stage_a=a_only, stage_a_and_b=a_and_b,
                   schedule=list(N.stage_a_schedule(B, k)))
        out.append(row)
        print(json.dumps({"ntt": {"shape": [B, k], **{
            name: [a_only[name]["ms"], a_and_b[name]["ms"]] for name in cands}}}), flush=True)
    return dict(shapes=out)


# the fused EC add's shapes (rows, lanes) on the serial route of a k=17
# proof (grow (R, K), boundary scan (R, 2K), R = 20 a commitment of the
# batch) and the v1 route (scan, one MSM: (20, 4096)), chip_smoke's
# recording; and chip_smoke's checked shape, (180, 2048)
EC_SHAPES = tuple((r, w) for r in (20, 40, 60, 140, 160) for w in (2048, 4096)) + ((180, 2048),)


def ec_turns(parent: Path | None, dev, rounds: int) -> dict:
    """The fused EC add at EC_SHAPES, this tree's and the parent's, in turns."""
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch.ops import ec as E
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    curve = E.BN254_CURVE
    f = curve.field
    srs = get_srs(17, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    libs = {"this": K.lib("ec")}
    if parent:
        libs["parent"] = _load(parent_library(parent, "ec"), "wh2_ec_add_unsafe",
                               K._SIGNATURES["wh2_ec_add_unsafe"])
    out = []
    for rows, lanes in EC_SHAPES:
        p, q, adds = CS._ec_operands(srs, gen, dev, rows, lanes)
        p, q = (E.JPoint(*(c.contiguous() for c in pt)) for pt in (p, q))
        n = rows * lanes

        def call(lib, p=p, q=q, n=n):
            o = E.JPoint(*(torch.empty_like(p.x) for _ in range(3)))
            K.check(lib.wh2_ec_add_unsafe(*(t.data_ptr() for t in (*p, *q, *o)), n,
                                          K.modulus_words(f), f.n0, K.stream_ptr(dev)), "EC add")
            return o

        want = E.add_unsafe(curve, p, q)
        for name, lib in libs.items():
            if CS._pt_err(call(lib), want):
                raise SystemExit(f"the {name} EC add disagrees with add_unsafe at {(rows, lanes)}")
        times = _turns({name: (lambda lib=lib: call(lib)) for name, lib in libs.items()},
                       rounds, 20, 10)
        row = dict(shape=[rows, lanes], adds=adds,
                   bound_ms=RL.bound_ms(RL.ec_add_work(rows, lanes, adds))[0], times=times)
        out.append(row)
        print(json.dumps({"ec": {"shape": [rows, lanes], "bound_ms": row["bound_ms"],
                                 **{k: v["ms"] for k, v in times.items()}}}), flush=True)
    return dict(shapes=out)


def montmul_turns(parent: Path, dev) -> dict:
    """The parent tree's montmul kernel and this tree's at (8, 2^19), warm
    and cold, in turns."""
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.ops import modops as M

    old = _load(parent_library(parent, "montmul"), "wh2_montmul", K._SIGNATURES["wh2_montmul"])
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
    return dict(shape="(8, 2^19)", bound_ms=RL.bound_ms(RL.montmul_work(n))[0], turns=rows)


def parent_mxu_constants(parent: Path, spec_name: str) -> dict:
    """The parent tree's int8-montmul matrices, as its kernel takes them
    ((width, depth)), and its scalars, made by its own ops/mxu_mod.py in a
    process of its own and kept in the parent's build directory."""
    import numpy as np

    path = parent.resolve() / "build" / f"mxu_constants_{spec_name}.npz"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        code = (
            "import numpy as np\n"
            "from webauthn_halo2_tpu_torch.fields import limbs\n"
            "from webauthn_halo2_tpu_torch.ops import mxu_mod as X\n"
            f"cs = X.consts(limbs.{spec_name.upper()}_SPEC)\n"
            "t = lambda m: np.ascontiguousarray(np.swapaxes(m, -1, -2))\n"
            f"np.savez({str(path)!r}, ev=t(cs.ev), iv=t(cs.iv), fold=t(cs.fold),\n"
            "         scalars=np.array([cs.qinv[0], cs.qinv[1], cs.inv12, cs.pt1], np.uint64))\n")
        subprocess.run([sys.executable, "-c", code], cwd=parent, check=True)
    return dict(np.load(path))


def mxu_turns(parent: Path, dev, rounds: int) -> dict:
    """The parent tree's int8 montmul and this tree's at (8, 2^19) Fr and
    (8, 2^12) Fq, in turns from CUDA graph replays."""
    import chip_smoke as CS
    from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.ops import modops as M
    from webauthn_halo2_tpu_torch.ops import mxu_mod as X

    old = _load(parent_library(parent, "mxu"), "wh2_mxu_montmul",
                [K._P, K._P, K._P, K._LL, K._P, K._P, K._P, K._U32P, K._U32, K._U32, K._U32,
                 K._U64, K._P])
    gen = torch.Generator(device=dev).manual_seed(23)
    out = []
    for spec, logn in ((FR_SPEC, 19), (FQ_SPEC, 12)):
        n = 1 << logn
        c = parent_mxu_constants(parent, spec.name.split("_")[1])
        mats = {k: torch.as_tensor(c[k]).to(dev) for k in ("ev", "iv", "fold")}
        qinv1, qinv2, inv12, pt1 = (int(v) for v in c["scalars"])
        a = CS._rand_words(spec, (n,), gen, dev)
        b = CS._rand_words(spec, (n,), gen, dev)

        def parent_call(spec=spec, a=a, b=b, n=n, mats=mats, s=(qinv1, qinv2, inv12, pt1)):
            o = torch.empty_like(a)
            K.check(old.wh2_mxu_montmul(a.data_ptr(), b.data_ptr(), o.data_ptr(), n,
                                        mats["ev"].data_ptr(), mats["iv"].data_ptr(),
                                        mats["fold"].data_ptr(), K.modulus_words(spec), *s,
                                        K.stream_ptr(dev)), "parent int8 montmul")
            return o

        calls = {"parent": parent_call,
                 "this": lambda spec=spec, a=a, b=b: X.mxu_montmul_rows_cuda(spec, a, b)}
        want = M.montmul_cuda(spec, a, b)
        if not torch.equal(X.mxu_montmul_rows_plain(spec, a, b), want):
            raise SystemExit(f"the int8 montmul's plain version disagrees ({spec.name})")
        for name, fn in calls.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"the {name} int8 montmul disagrees ({spec.name}, 2^{logn})")
        times = _turns(calls, rounds, 100, 20)
        clocks = {name: CS._clocks_during(fn)[1:] for name, fn in calls.items()}
        row = dict(field=spec.name, shape=f"(8, 2^{logn})", times=times,
                   clocks={k: dict(sm_mhz=v[0], power_w=v[1]) for k, v in clocks.items()})
        out.append(row)
        print(json.dumps({"mxu": {"field": spec.name, "shape": row["shape"],
                                  **{k: v["ms"] for k, v in times.items()}}}), flush=True)
    return dict(shapes=out)


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
        row = dict(batch=i, rows=R, bound_ms=RL.bound_ms(stages["msm_combine"])[0],
                   configs=[dict(G=G, P=P, **times[(G, P)]) for G, P in grid])
        results.append(row)
        print(json.dumps(row), flush=True)

    proof = {f"{G}:{P}": sum(_median(x["ms"]) for r in results for x in r["configs"]
                             if (x["G"], x["P"]) == (G, P)) for G, P in grid}
    return dict(batches=results, proof_median_ms=proof,
                proof_bound_ms=sum(r["bound_ms"] for r in results))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--parts", default="sass,ntt,ec,montmul,combine,mxu")
    ap.add_argument("--grid", default="512:256,1024:128,1024:256,2048:128,2048:256")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="build/sweep_kernels.json")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
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
    if "sass" in parts:
        report["sass"] = {"this": {src: sass_counts(K._so_path(src), kern)
                                   for src, kern in SASS_KERNELS}}
        if args.parent:
            report["sass"]["parent"] = {src: sass_counts(parent_library(args.parent, src), kern)
                                        for src, kern in SASS_KERNELS}
        report["sass_mxu"] = {}
        for tree, per in report["sass"].items():
            loops = next(iter(per["mxu"].values()))["loops"]
            report["sass_mxu"][tree] = dict(loops=loops, issue=mxu_issue_per_element(
                loops, *MXU_LOOP_TRIPS[tree]))
        print(json.dumps({"sass": {tree: {src: {k: v["instructions"] for k, v in kern.items()}
                                          for src, kern in per.items()}
                                   for tree, per in report["sass"].items()}}), flush=True)
        print(json.dumps({"sass_mxu": report["sass_mxu"]}), flush=True)
    if "ntt" in parts:
        report["ntt"] = ntt_turns(args.parent, dev, args.rounds)
    if "ec" in parts:
        report["ec"] = ec_turns(args.parent, dev, args.rounds)
    if "montmul" in parts and args.parent:
        report["montmul_turns"] = montmul_turns(args.parent, dev)
        print(json.dumps({"montmul_turns": report["montmul_turns"]}), flush=True)
    if "combine" in parts:
        grid = [tuple(int(v) for v in g.split(":")) for g in args.grid.split(",")]
        report["combine"] = combine_grid(dev, grid, args.rounds)
        print(json.dumps({"combine_proof_median_ms": report["combine"]["proof_median_ms"],
                          "proof_bound_ms": report["combine"]["proof_bound_ms"]}), flush=True)
    if "mxu" in parts and args.parent:
        report["mxu"] = mxu_turns(args.parent, dev, args.rounds)
    report["seconds"] = time.time() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(report["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
