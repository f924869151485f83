#!/usr/bin/env python3
"""Data-parallel proving of N ECDSA-P256 signatures across processes, cards
and hosts (BASELINE config 5): the port of scripts/launch_multihost.py.

N independent signatures, N proofs: rank r proves its round-robin shard
i % ranks == r (webauthn_halo2_tpu_torch/parallel/batch.py) through
api.prove_batch on its own card, verifies every proof it made, and the
ranks gather each other's indices, proof digests, seconds and vk digest.
No collective runs inside a proof. Every rank derives the same keys from
the deterministic SRS (or loads one key file, --keys), and the ranks must
agree on the vk digest.

One host, one rank a card (with --ranks-per-card R, R gloo ranks share
each card):

    python3 scripts/launch_multihost_torch.py --batch 16

P ranks on this host's cards (P > cards: gloo ranks share them):

    python3 scripts/launch_multihost_torch.py --simulate 4 --batch 16

Several hosts, one command per host (host 0 serves the rendezvous):

    python3 scripts/launch_multihost_torch.py --coordinator <host0>:29500 \\
        --num-hosts 2 --host-id <i> --batch 64

The signatures come from --seed, the same on every host (index i takes
the first draw whose witness the circuit can build: its incomplete point
additions, as the reference circuit's, reject a few valid signatures,
which the merged line lists), and proof i is made with a deterministic
rng of (seed, i), so the bytes of a proof do not depend on which rank
made it. Host 0 first proves the same N signatures in
this one process with api.generate_proofs_batch (after one warm-up proof):
the one-process baseline, whose proofs every rank's must equal. With two
or more cards it also checks, in this process (current device 0), that
api.generate_proof and generate_proofs_batch with device="cuda:1" give the
cuda:0 bytes. Each rank keys (or loads its key), proves one warm-up proof,
then its shard. Every rank prints to its own log under the run directory
(a new directory under build/, removed at the end); a rank that fails
fails the job, naming the rank, and every rank's log tail is printed.

Prints, one JSON line a rank, the JAX script's fields (host, proved,
vk_digest, wall_s, per_proof_s, steady_proofs_per_s, proofs_per_s) with
the rank, its card and its peak memory; then the cards' names and power
limits (nvidia-smi); last, the merged line: ranks, hosts, cards, the
batch's proofs/s (N over the slowest rank's shard, the ranks started
together), the one-process baseline's proofs/s, the scaling efficiency =
proofs/s / (ranks x the baseline's proofs/s), and the checks.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# seconds a collective waits: ranks that wait for host 0's one-process
# baseline, or for a rank that failed on another host, give up after it
TIMEOUT = 1200.0


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank of this host needs (pickled to the spawned ranks)."""
    requests: list
    degree: int
    seed: int
    keys: str | None
    log_dir: str
    local_ranks: int


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


class _Seeded:
    """`randbelow` over a seeded generator, for ref_curve.ecdsa_keygen."""

    def __init__(self, seed: str):
        self.r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self.r.randrange(n)


def signed_request(draw: str) -> dict:
    """A ProveRequestBody dict (LE byte lists) of an ECDSA-P256 signature
    whose key, message and nonce come from the string `draw`."""
    from webauthn_halo2_tpu_torch.fields.ref_curve import P256_CURVE, ecdsa_keygen, ecdsa_sign

    sk, pub = ecdsa_keygen(rng=_Seeded(f"{draw}:key"))
    rng = _Seeded(f"{draw}:message")
    m = rng.randbelow(P256_CURVE.n)
    r, s = ecdsa_sign(m, sk, k=1 + rng.randbelow(P256_CURVE.n - 1))
    return {name: list(int(v).to_bytes(32, "little"))
            for name, v in zip(("r", "s", "pubkey_x", "pubkey_y", "msghash"), (r, s, *pub, m))}


def signed_requests(n: int, seed: int, params) -> tuple[list[dict], list[dict]]:
    """N signatures for the circuit at `params`: for index i the first draw
    "seed:i:attempt" whose witness the circuit builds. The ECDSA circuit's
    incomplete point additions (circuits/ecc.add_unequal, as in the
    reference circuit) cannot witness some valid signatures; the draws
    they rejected come back as the second value."""
    from webauthn_halo2_tpu_torch import api

    out, rejected = [], []
    for i in range(n):
        for attempt in itertools.count():
            req = signed_request(f"{seed}:{i}:{attempt}")
            try:
                api.request_witnesses([req], params)[0]()
            except ValueError as e:
                rejected.append(dict(index=i, attempt=attempt, error=str(e)))
                continue
            out.append(req)
            break
    return out, rejected


def rng_seed(seed: int, i: int) -> bytes:
    """The prover rng's seed of proof i (parallel/batch.seeded_rng)."""
    return f"launch_multihost_torch:{seed}:{i}".encode()


def params_for(degree: int):
    """The production CircuitParams at k=17, else auto_params(k) as the JAX
    script sizes its circuit."""
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams, auto_params

    return CircuitParams() if degree == CircuitParams().degree else auto_params(degree)


def _gb(nbytes: int) -> float:
    return round(nbytes / 1e9, 3)


def one_process(job: Job, dev) -> dict:
    """The baseline: the N signatures proved in this process by
    api.generate_proofs_batch on one device, after one warm-up proof."""
    import hashlib

    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.parallel.batch import seeded_rng

    params = params_for(job.degree)
    t0 = time.time()
    api.proving_key(params, device=dev, cache_dir=job.keys)
    keys_s = time.time() - t0
    api.generate_proofs_batch(job.requests[:1], params=params, device=dev,
                              rngs=[seeded_rng(b"warm-up")])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    proofs = api.generate_proofs_batch(
        job.requests, params=params, device=dev,
        rngs=[seeded_rng(rng_seed(job.seed, i)) for i in range(len(job.requests))])
    s = time.perf_counter() - t0
    return dict(device=str(dev), keys_s=keys_s, s=s, proofs_per_s=len(proofs) / s,
                peak_gb=_gb(torch.cuda.max_memory_allocated(dev)), proofs=proofs,
                digests=[hashlib.sha256(p).hexdigest() for p in proofs])


def second_card_check(job: Job, baseline: dict) -> dict:
    """In this process, whose current device is 0: generate_proof and
    generate_proofs_batch on cuda:1 give the bytes of cuda:0."""
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.parallel.batch import seeded_rng

    if torch.cuda.current_device() != 0:
        fail(f"the current device is {torch.cuda.current_device()}, not 0")
    params = params_for(job.degree)
    t0 = time.time()
    one = api.generate_proof(*(bytes(job.requests[0][k]) for k in
                               ("r", "s", "pubkey_x", "pubkey_y", "msghash")),
                             params=params, device="cuda:1",
                             rng=seeded_rng(rng_seed(job.seed, 0)))
    two = api.generate_proofs_batch(job.requests[:2], params=params, device="cuda:1",
                                    rngs=[seeded_rng(rng_seed(job.seed, i)) for i in range(2)])
    out = dict(current_device=torch.cuda.current_device(), s=time.time() - t0,
               generate_proof_equal=one == baseline["proofs"][0],
               generate_proofs_batch_equal=two == baseline["proofs"][:2])
    if not (out["generate_proof_equal"] and out["generate_proofs_batch_equal"]
            and out["current_device"] == 0):
        fail(f"proving on cuda:1 from a thread on cuda:0 gave other bytes: {out}")
    return out


def _rank(rank: int, world: int, job: Job) -> dict:
    """One rank: its card, its key, one warm-up proof, then its shard."""
    t_start = time.time()
    local = int(os.environ["LOCAL_RANK"])
    sys.stdout = sys.stderr = open(os.path.join(job.log_dir, f"rank{rank}.log"), "w",
                                   buffering=1)
    # the ranks of a host share its cores; torch's one thread a core would oversubscribe them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job.local_ranks))
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.parallel import batch as B
    from webauthn_halo2_tpu_torch.parallel import sharded as S

    dev = S.make_mesh().device  # cuda:(rank % cards)
    params = params_for(job.degree)
    t0 = time.time()
    pk = api.proving_key(params, device=dev, cache_dir=job.keys)
    keys_s = time.time() - t0
    witnesses = api.request_witnesses(job.requests, params)
    t0 = time.time()
    api.prove_batch(pk, witnesses[:1], rngs=[B.seeded_rng(b"warm-up")])
    warmup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    shard = B.prove_shard(pk, witnesses, [B.seeded_rng(rng_seed(job.seed, i))
                                          for i in range(len(witnesses))])
    mine = shard.ranks[rank]
    n = len(mine["indices"])
    return dict(rank=rank, local_rank=local, keys_s=keys_s, warmup_s=warmup_s,
                wall_s=time.time() - t_start, thread_device=torch.cuda.current_device(),
                records=shard.ranks, digests=shard.digests, proved=n)


def _jax_line(host: int, r: dict) -> dict:
    """A rank's line: the JAX script's fields, then the port's."""
    rec = r["records"][r["rank"]]
    prove_s = rec["prove_s"]
    n = r["proved"]
    return {"host": host, "proved": rec["indices"], "vk_digest": hex(rec["vk"])[:34],
            "wall_s": round(r["wall_s"], 2), "per_proof_s": [round(prove_s / max(n, 1), 3)],
            "steady_proofs_per_s": round(n / max(prove_s, 1e-9), 4),
            "proofs_per_s": round(n / r["wall_s"], 4),
            "rank": r["rank"], "device": rec["device"], "keys_s": round(r["keys_s"], 2),
            "warmup_s": round(r["warmup_s"], 2), "prove_s": prove_s,
            "verify_s": rec["verify_s"], "peak_gb": _gb(rec["peak_bytes"])}


def _rank_logs(log_dir: str) -> None:
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as f:
                log(f"--- {name} (tail) ---\n{f.read()[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default="", help="host:port of host 0's rendezvous")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--simulate", type=int, default=0,
                    help="P ranks on this host's cards (more ranks than cards share them)")
    ap.add_argument("--ranks-per-card", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", default=None,
                    help="a key directory every rank loads (written first if missing)")
    args = ap.parse_args()
    t_all = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this launcher proves on cards")
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks
    from webauthn_halo2_tpu_torch.utils import host_build as HB

    cards = torch.cuda.device_count()
    local = args.simulate or cards * args.ranks_per_card
    ranks = local * args.num_hosts
    if args.backend == "nccl" and local > cards:
        fail(f"NCCL takes one rank a card: {local} ranks on {cards} cards; use gloo")
    if local > cards:
        log(f"[ranks] {local} gloo ranks share {cards} card(s): rank r on cuda:(r % {cards})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.time()
    K.build_all()  # here, once, before the ranks load the libraries
    HB.build_all()
    log(f"[build] kernels and host libraries in {time.time() - t0:.1f}s")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="launch_multihost_torch_", dir=os.path.join(ROOT, "build"))
    t0 = time.time()
    requests, rejected = signed_requests(args.batch, args.seed, params_for(args.k))
    log(f"[signatures] {args.batch} drawn in {time.time() - t0:.1f}s; draws the circuit "
        f"cannot witness: {json.dumps(rejected)}")
    job = Job(requests=requests, degree=args.k, seed=args.seed,
              keys=args.keys and os.path.abspath(args.keys),
              log_dir=run_dir, local_ranks=local)
    baseline = check = None
    if args.host_id == 0:
        dev = torch.device("cuda", 0)
        baseline = one_process(job, dev)
        log(f"[one process] {args.batch} proofs on {dev} in {baseline['s']:.2f}s: "
            f"{baseline['proofs_per_s']:.4f} proofs/s (key {baseline['keys_s']:.1f}s)")
        if cards >= 2:
            check = second_card_check(job, baseline)
            log(f"[cuda:1] from a thread on cuda:0: {json.dumps(check)}")
        torch.cuda.empty_cache()
    t0 = time.time()
    try:
        results = run_ranks(_rank, local, os.path.join(run_dir, f"host{args.host_id}"),
                            backend=args.backend, args=(job,), timeout=TIMEOUT,
                            coordinator=args.coordinator or None, num_hosts=args.num_hosts,
                            host_id=args.host_id)
    except Exception as e:  # noqa: BLE001 - a failed rank fails the job
        _rank_logs(run_dir)
        fail(f"the ranks failed: {e}")
    ranks_s = time.time() - t0
    for r in results:
        print(json.dumps(_jax_line(args.host_id, r)), flush=True)
    records = results[0]["records"]  # every rank's, gathered to each
    # launch_multihost.py's assertions: every proof verified on the rank that
    # made it (batch.prove_shard raises otherwise), one vk digest across ranks
    if any(rec["invalid"] for rec in records):
        fail(f"a proof did not verify: {[(rec['rank'], rec['invalid']) for rec in records]}")
    digests = {hex(rec["vk"])[:34] for rec in records}
    if len(digests) != 1:
        fail(f"ranks derived different vks: {digests}")
    proved = sorted(i for rec in records for i in rec["indices"])
    if proved != list(range(args.batch)):
        fail(f"the ranks proved {proved}, not each of 0..{args.batch - 1} once")
    shard_s = max(rec["prove_s"] for rec in records)
    pps = args.batch / shard_s
    out = {"ranks": ranks, "hosts": args.num_hosts, "cards": cards,
           "ranks_per_card": local / cards, "backend": args.backend,
           "batch": args.batch, "k": args.k, "proved": len(proved),
           "vk_digest": digests.pop(), "proofs_per_s": pps, "slowest_shard_s": shard_s,
           "ranks_s": ranks_s, "peak_gb": [_gb(rec["peak_bytes"]) for rec in records],
           "thread_devices": [r["thread_device"] for r in results], "card": smi}
    if baseline is not None:
        got = results[0]["digests"]
        equal = [got[i] == d for i, d in enumerate(baseline["digests"])]
        if not all(equal):
            fail(f"indices {[i for i, e in enumerate(equal) if not e]} differ from "
                 "the one-process proofs")
        out.update(bytes_equal_one_process=True, one_process={
            k: baseline[k] for k in ("device", "s", "proofs_per_s", "peak_gb", "keys_s")},
            scaling_efficiency=pps / (ranks * baseline["proofs_per_s"]))
    out["second_card"] = check or f"skipped: {cards} card(s)"
    out["draws_rejected_by_the_circuit"] = rejected
    out["seconds"] = time.time() - t_all
    log(f"all {len(proved)} proofs verified across {ranks} ranks; "
        f"vk digest identical: {out['vk_digest']}")
    shutil.rmtree(run_dir, ignore_errors=True)
    for line in smi:
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
