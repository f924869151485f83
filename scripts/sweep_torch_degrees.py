#!/usr/bin/env python3
"""The ECDSA-P256 circuit at each degree of the reference's benchmark, keyed,
proved and verified on one card: the port of bench_sweep.py's path.

    python3 scripts/sweep_torch_degrees.py [--degrees 11,12,13,14,15,16,17,18,19]
        [--seed 0] [--out build/degrees]

For each degree k, in order:
  1. get_srs(k): the committed file at k = 6 and 17, else a file of the
     port's format under build/srs/, else generated on the card and saved
     there; its first min(2^k, 2^17) monomial points must equal the
     committed k = 17 file's (they depend only on the seed);
  2. the circuit's columns: auto_params(k), grown as bench_sweep.py grows
     them while the build raises AssertionError (balanced placement first,
     then one more advice column a try, a lookup column at the fourth);
     at k = 17 the production CircuitParams(). Where a fixed column of
     the fitted build is longer than 2^k (the constants column at k = 11
     and 12: about 5,830 distinct constants), the JAX package's keygen
     raises and so must api.download_keys here; the degree is listed under
     "not_keyable" with that message, and the sweep goes on;
  3. api.download_keys(k, ...) of those params into a new directory under
     --out (the key file and the two manifests; removed after the degree),
     then the in-memory keys dropped, so that every later call takes its
     params from the manifest and its key from the manifest's directory;
  4. one seeded ECDSA-P256 signature (the first draw the circuit can
     witness, as scripts/launch_multihost_torch.py draws), a warm-up proof
     with api.generate_proof (which loads the key file), then the timed
     proof of the same signature;
  5. api.verify on the native host verifier (timed) and on the Python one,
     each accepting the proof and rejecting a copy with one byte flipped;
  6. api.generate_proof_evm (GWC over Keccak) and api.verify_evm on it and
     on a flipped copy.

Prints one line a degree with the columns of results/ecdsa_bench.csv
(degree, num_advice, num_lookup, num_fixed, lookup_bits, limb_bits,
num_limbs, proof_time, proof_size, verify_time) plus keygen seconds and
the peak device memory, and writes those rows to --out/ecdsa_bench_torch.csv,
never to results/. Then each degree's details as one JSON line, the
card's name and power limit (nvidia-smi), and last a JSON line with the
check against the JAX rows of results/ecdsa_bench.csv: at each degree that
has such rows, the columns and the proof size must equal them. Where the
columns the fit gives differ from a row's, the row's own columns are keyed
and proved as well, and the proof size at them must equal the row's.
Exits 1 at the first failure: a wrong verdict, a proof size unequal to a
JAX row's, a degree that keys although its fixed columns do not fit.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))

DEGREES = (11, 12, 13, 14, 15, 16, 17, 18, 19)
REFERENCE_CSV = os.path.join(ROOT, "results", "ecdsa_bench.csv")
CSV_HEADER = ("degree,num_advice,num_lookup,num_fixed,lookup_bits,limb_bits,num_limbs,"
              "proof_time,proof_size,verify_time,keygen_s,peak_gb")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def fit_params(degree: int):
    """(CircuitParams, the AssertionErrors of the builds that did not fit,
    {index: rows} of the fitted build's fixed columns longer than 2^degree):
    bench_sweep.py's loop over auto_params(degree), or the production
    CircuitParams() at its degree. Raises
    RuntimeError after five builds that do not fit. The build does not
    check the fixed columns' lengths; keygen refuses a column longer than
    2^degree (the reference circuit's constants column at k = 11 and 12)."""
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import (CircuitParams, ECDSACircuit,
                                                                 ECDSAInputs, auto_params)

    params = CircuitParams() if degree == CircuitParams().degree else auto_params(degree)
    misses = []
    for attempt in range(5):
        try:
            _cs, fixed, _advice, _copies = ECDSACircuit(params).build(ECDSAInputs.dummy())
            return params, misses, {i: len(c) for i, c in enumerate(fixed)
                                    if len(c) > 1 << degree}
        except AssertionError as e:
            misses.append(str(e))
            if not params.balance_columns:
                params.balance_columns = True
            else:
                params.num_advice += 1
                params.num_lookup_advice += attempt == 3
    raise RuntimeError(f"k={degree}: the circuit did not fit in five builds: {misses}")


def reference_rows() -> dict:
    """{degree: [(num_advice, num_lookup, proof_size), ...]} of the JAX rows
    of results/ecdsa_bench.csv."""
    rows: dict = {}
    with open(REFERENCE_CSV) as f:
        for r in csv.DictReader(f):
            rows.setdefault(int(r["degree"]), []).append(
                (int(r["num_advice"]), int(r["num_lookup"]), int(r["proof_size"])))
    return rows


def flip(data: bytes) -> bytes:
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 1
    return bytes(bad)


def _args(req: dict) -> tuple:
    return tuple(bytes(req[k]) for k in ("r", "s", "pubkey_x", "pubkey_y", "msghash"))


def srs_prefix_equal(k: int, dev) -> bool:
    """The first min(2^k, 2^17) monomial points of get_srs(k) equal the
    committed k = 17 SRS's."""
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    m = 1 << min(k, 17)
    a, b = get_srs(k, device=dev).g_mono, get_srs(17, device=dev).g_mono
    return all(torch.equal(x[:, :m], y[:, :m]) for x, y in zip(a, b))


def prove_degree(params, seed: int, out_dir: str, dev) -> dict:
    """Steps 3-6 at `params`; returns the degree's numbers. Fails the run
    on a wrong verdict."""
    from launch_multihost_torch import signed_requests

    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.parallel.batch import seeded_rng
    from webauthn_halo2_tpu_torch.utils.host_build import python_oracles

    k = params.degree
    key_dir = tempfile.mkdtemp(prefix=f"keys_k{k}_", dir=out_dir)
    pk_path = os.path.join(key_dir, "proving_key.pk")
    vk_path = os.path.join(key_dir, "verifying_key.vk")
    try:
        t0 = time.time()
        api.download_keys(k, pk_path, vk_path, params=params, device=dev)
        torch.cuda.synchronize(dev)
        keygen_s = time.time() - t0
        key_files = [f for f in os.listdir(key_dir) if f.endswith(".torch.npz")]
        key_bytes = sum(os.path.getsize(os.path.join(key_dir, f)) for f in key_files)
        api._PK_CACHE.clear()  # the key comes from the manifest's directory now
        (req,), rejected = signed_requests(1, seed, params)
        t0 = time.time()
        warm = api.generate_proof(*_args(req), proving_key_path=pk_path, device=dev,
                                  rng=seeded_rng(b"sweep_torch_degrees:warm-up"))
        warm_s = time.time() - t0
        if len(api._PK_CACHE) != 1:
            fail(f"k={k}: the proof did not take its key from {key_dir}")
        t0 = time.time()
        proof = api.generate_proof(*_args(req), proving_key_path=pk_path, device=dev,
                                   rng=seeded_rng(b"sweep_torch_degrees"))
        proof_s = time.time() - t0
        verdicts = {}
        for path in ("native", "python"):
            with python_oracles() if path == "python" else contextlib.nullcontext():
                t0 = time.time()
                ok = api.verify(proof, vk_path, device=dev)
                verdicts[path] = dict(valid=ok, valid_s=time.time() - t0,
                                      flipped=api.verify(flip(proof), vk_path, device=dev),
                                      warm_up=api.verify(warm, vk_path, device=dev))
            if [verdicts[path][v] for v in ("valid", "flipped", "warm_up")] != [True, False, True]:
                fail(f"k={k}: the {path} verifier answered {verdicts[path]}")
        t0 = time.time()
        gwc = api.generate_proof_evm(*_args(req), proving_key_path=pk_path, device=dev,
                                     rng=seeded_rng(b"sweep_torch_degrees:gwc"))
        gwc_s = time.time() - t0
        gwc_ok = api.verify_evm(gwc, vk_path, device=dev), api.verify_evm(flip(gwc), vk_path,
                                                                           device=dev)
        if gwc_ok != (True, False):
            fail(f"k={k}: verify_evm answered {gwc_ok} for the GWC proof and a flipped copy")
    finally:
        api._PK_CACHE.clear()
        shutil.rmtree(key_dir, ignore_errors=True)
    return dict(keygen_s=keygen_s, key_file_bytes=key_bytes, warm_up_s=warm_s,
                proof_s=proof_s, proof_bytes=len(proof), verify=verdicts,
                gwc_s=gwc_s, gwc_bytes=len(gwc), rejected_draws=rejected)


def csv_row(r: dict) -> str:
    """A degree's row: the reference CSV's columns in its formats, then
    keygen seconds and peak GB."""
    p = r["params"]
    return (f"{p['degree']},{p['num_advice']},{p['num_lookup_advice']},"
            f"{p['num_fixed']},{p['lookup_bits']},{p['limb_bits']},{p['num_limbs']},"
            f"{r['proof_s']:.3f}s,{r['proof_bytes']},{r['verify']['native']['valid_s'] * 1e3:.3f}ms,"
            f"{r['keygen_s']:.3f},{r['peak_gb']}")


def run_degree(params, seed: int, out_dir: str, dev, misses=()) -> dict:
    """The SRS, then steps 3-6 at `params`, with the peak device memory."""
    from webauthn_halo2_tpu_torch.plonk import srs as S

    k = params.degree
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    generated = not any(os.path.exists(p) for p in S.srs_paths(k))
    S.get_srs(k, device=dev)
    torch.cuda.synchronize(dev)
    srs_s = time.time() - t0
    if not srs_prefix_equal(k, dev):
        fail(f"k={k}: the SRS's monomial points are not the committed k=17 SRS's")
    r = prove_degree(params, seed, out_dir, dev)
    r.update(degree=k, params=dataclasses.asdict(params), fit_misses=list(misses),
             srs_s=srs_s, srs_generated=generated,
             peak_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 3))
    log(f"[k={k}] {params.num_advice}/{params.num_lookup_advice} columns, "
        f"balance={params.balance_columns}: SRS {srs_s:.1f}s (generated: {generated}), "
        f"keygen {r['keygen_s']:.1f}s, proof {r['proof_s']:.3f}s ({r['proof_bytes']} bytes), "
        f"verify {r['verify']['native']['valid_s']:.3f}s, GWC {r['gwc_s']:.2f}s, "
        f"peak {r['peak_gb']} GB")
    return r


def refused_degree(params, out_dir: str, dev) -> str:
    """At a degree whose fixed columns do not fit: api.download_keys must
    raise ValueError, as the JAX package's keygen does. Returns its
    message."""
    from webauthn_halo2_tpu_torch import api

    key_dir = tempfile.mkdtemp(prefix=f"keys_k{params.degree}_", dir=out_dir)
    try:
        api.download_keys(params.degree, os.path.join(key_dir, "proving_key.pk"),
                          os.path.join(key_dir, "verifying_key.vk"), params=params, device=dev)
    except ValueError as e:
        return str(e)
    finally:
        api._PK_CACHE.clear()
        shutil.rmtree(key_dir, ignore_errors=True)
    fail(f"k={params.degree}: download_keys keyed a circuit whose fixed columns do not fit")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--degrees", default=",".join(map(str, DEGREES)))
    ap.add_argument("--seed", type=int, default=0, help="the signatures' draws")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "degrees"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this sweep proves on a card")
    degrees = [int(k) for k in args.degrees.split(",")]
    dev = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(args.out, exist_ok=True)
    out_csv = os.path.join(args.out, "ecdsa_bench_torch.csv")
    reference = reference_rows()
    print(CSV_HEADER, flush=True)
    results, checks, refused = [], {}, {}
    with open(out_csv, "w") as f:
        f.write(CSV_HEADER + "\n")
        for k in degrees:
            t0 = time.time()
            params, misses, overlong = fit_params(k)
            fit_s = time.time() - t0
            log(f"[k={k}] fitted {params} in {fit_s:.1f}s after {len(misses)} misses: {misses}")
            if overlong:
                refused[k] = dict(params=dataclasses.asdict(params), fixed_rows=overlong,
                                  n=1 << k, download_keys=refused_degree(params, args.out, dev))
                log(f"[k={k}] not keyable, as in the JAX package: {json.dumps(refused[k])}")
                drop_srs(k, dev)
                continue
            r = run_degree(params, args.seed, args.out, dev, misses)
            r["fit_s"] = fit_s
            rows = [r]
            got = (params.num_advice, params.num_lookup_advice, r["proof_bytes"])
            for na, nl, size in sorted(set(reference.get(k, []))):
                check = dict(reference=[na, nl, size], fitted=list(got), equal=got == (na, nl, size))
                if (na, nl) != got[:2]:
                    # the row's own columns, keyed and proved beside the fit
                    own = dataclasses.replace(params, num_advice=na, num_lookup_advice=nl)
                    r2 = run_degree(own, args.seed, args.out, dev)
                    r2["reference_columns"] = True
                    rows.append(r2)
                    check.update(at_reference_columns=r2["proof_bytes"],
                                 size_equal=r2["proof_bytes"] == size)
                    if r2["proof_bytes"] != size:
                        fail(f"k={k}: {r2['proof_bytes']} bytes at the reference's {na}/{nl} "
                             f"columns, not {size}")
                elif r["proof_bytes"] != size:
                    fail(f"k={k}: {r['proof_bytes']} bytes, not the reference's {size}")
                checks.setdefault(k, []).append(check)
            for row in rows:
                line = csv_row(row)
                print(line, flush=True)
                f.write(line + "\n")
                f.flush()
            results += rows
            drop_srs(k, dev)
    for r in results:
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi or "nvidia-smi gave nothing", flush=True)
    print(json.dumps({"degrees": degrees, "csv": os.path.relpath(out_csv, ROOT),
                      "reference": os.path.relpath(REFERENCE_CSV, ROOT),
                      "checks": checks, "not_keyable": refused, "card": smi}), flush=True)
    return 0


def drop_srs(k: int, dev) -> None:
    """Drop the degree's SRS from memory (not the committed k=17 one, which
    every degree's check reads) and return the card's cached blocks."""
    from webauthn_halo2_tpu_torch.plonk import srs as S

    if k != 17:
        S._SRS_MEM_CACHE.pop((k, b"dev", str(dev)), None)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
