"""One rank of the prover pool: a process on its card that loads the key,
warms up, and then proves pairs of fresh signatures back to back, a closed
loop, until the window closes.

`rank_main(rank, world, job)` runs under the program's
`parallel/ranks.run_ranks` (a gloo group, for the barrier and the start
time). `job` carries the cell: the system, its parameters, the traffic, the
seed, the window and, for the benchmark's own tests and its control only, a
fault to plant (FAULTS).
"""
from __future__ import annotations

import importlib
import sys
import threading
import time

from .plain import BN_R, ecdsa_request, ecdsa_valid

BANNED = ("jax", "jaxlib", "flax", "webauthn_halo2_tpu")
# faults a run can be given, each breaking the timed path underneath:
# control: a proof of a witness with one input cell changed (the soundness
# guarantee broken); altered: a proof byte flipped where it is produced;
# half: the second proof of a call replaced by the first; stale: each
# witness after the first is the previous request's; exchange: the last
# rank's records never reach the parent; error: the first request's witness
# raises, inside the circuit's domain
FAULTS = ("control", "altered", "half", "stale", "exchange", "error")
# the set-up's warm-up call: the same two signatures in every rank and run
# (inside the circuit's domain, tests/test_port_bench_reference.py)
WARM_UP = ("warm-up", 0)


def traffic_request(seed: int, stream: str, index: int, signatures: str) -> tuple:
    """(request, draws again): request `index` of a rank's stream. With
    `signatures` "in_domain" (the cells' traffic), a signature that the
    circuit has no witness for (bp/reference.in_domain, about one in 137)
    is drawn again from the same stream until one lies inside, so that no
    request fails; with "uniform" the first draw stands, and its call fails."""
    from . import reference as ref

    req, again = ecdsa_request(seed, stream, index), 0
    while signatures == "in_domain" and not ref.in_domain(req):
        again += 1
        req = ecdsa_request(seed, f"{stream} again {again}", index)
    return req, again


def banned_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def load_system(job):
    mod, _, name = job["system"].partition(":")
    return getattr(importlib.import_module(mod), name)(job["params"])


class MemorySampler(threading.Thread):
    """The card's used memory (all processes on it), polled until stopped."""

    def __init__(self, card: int):
        super().__init__(daemon=True)
        self.card, self.peak, self.done = card, 0, threading.Event()

    def run(self):
        import torch

        while not self.done.is_set():
            free, total = torch.cuda.mem_get_info(self.card)
            self.peak = max(self.peak, total - free)
            self.done.wait(0.2)

    def stop(self) -> int:
        self.done.set()
        self.join()
        return self.peak


def check_witnesses(system, job: dict, rank: int, calls: list, kept: dict) -> dict:
    """The reference's check of the witness of every request this rank
    proved (bp/reference.witness_faults, and the signature itself), run in
    the rank once every rank's window has closed, so that the witnesses
    never leave it; with the digest of the layout it checked them against
    (the program's synthesis, which the parent holds against the
    configuration's)."""
    from . import reference as ref

    c = job["params"]
    circ = ref.Circuit(c["degree"], c["num_advice"], c["num_lookup_advice"], c["lookup_bits"])
    fixed, advice, copies = system.layout()
    digest = ref.layout_digest(circ, fixed, advice, copies)
    faults = checked = 0
    for call in calls:
        for i, proof in zip(call["idx"], call["proofs"]):
            if not proof:
                continue
            if i not in kept:  # a proof of no witness the harness handed over
                faults += 1
                continue
            adv, inst = kept.pop(i)
            req, _ = traffic_request(job["seed"], f"rank {rank}", i, job["signatures"])
            faults += ref.witness_faults(circ, fixed, copies, adv, inst, job["inputs"], req)
            faults += int(not ecdsa_valid(req))
            checked += 1
    return dict(layout_digest=digest, faults=faults, checked=checked)


def rank_main(rank: int, world: int, job: dict):
    import torch
    import torch.distributed as dist

    fault = job.get("fault")
    system = load_system(job)
    cards, per_call, seed = job["cards"], job["per_call"], job["seed"]
    card = rank % cards
    on_card = job["device"] == "cuda"
    if on_card:
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
    else:
        dev = torch.device("cpu")
    sampler = MemorySampler(card) if on_card and rank < cards else None
    if sampler:
        sampler.start()

    # set-up: the key (rank 0 first where its file is not there yet)
    t = time.time()
    if job["warm"]:
        pk = system.proving_key(dev)
    else:
        if rank == 0:
            pk = system.proving_key(dev)
        dist.barrier()
        if rank != 0:
            pk = system.proving_key(dev)
    key_s = time.time() - t
    inst = None
    if job["trace"] and on_card:
        from .trace import Instruments

        inst = Instruments(dev)
        inst.install()
    warm = [ecdsa_request(WARM_UP[1], WARM_UP[0], i) for i in range(per_call)]
    system.prove_batch(pk, system.witnesses(warm))
    if on_card:
        torch.cuda.synchronize(dev)
    prof = None
    if inst:
        inst.sample = inst.commits_per_proof()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        inst.armed = True
    dist.barrier()
    start = [time.time() + 0.25]
    dist.broadcast_object_list(start, src=0)
    t0 = start[0]
    t_end = t0 + job["seconds"]
    time.sleep(max(0.0, t0 - time.time()))

    kept, wtimes, prev = {}, [], [None]
    lock = threading.Lock()

    def timed(fn, idx):
        def call():
            s = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - s
            if fault == "control":
                advice = [list(c) for c in out[0]]
                advice[0][0] = (advice[0][0] + 1) % BN_R
                out = (advice, out[1])
            elif fault == "stale":
                out, prev[0] = (prev[0] or out), out
            elif fault == "error" and idx == 0:
                raise ValueError("a planted error")
            with lock:
                wtimes.append(dt)
                kept[idx] = out
            return out
        return call

    calls, j = [], 0
    while time.time() < t_end:
        idx = list(range(j, j + per_call))
        drawn = [traffic_request(seed, f"rank {rank}", i, job["signatures"]) for i in idx]
        reqs = [req for req, _ in drawn]
        ws = [timed(w, i) for w, i in zip(system.witnesses(reqs), idx)]
        t_call = time.time()
        err = None
        try:
            proofs = list(system.prove_batch(pk, ws))
        except Exception as e:  # a failed request counts as not returned
            proofs, err = [None] * per_call, [type(e).__name__, str(e)[:200]]
        t_ret = time.time()
        if fault == "altered" and proofs[0]:
            proofs[0] = proofs[0][:100] + bytes([proofs[0][100] ^ 1]) + proofs[0][101:]
        elif fault == "half" and len(proofs) > 1:
            proofs[1] = proofs[0]
        calls.append(dict(idx=idx, t_call=t_call, t_ret=t_ret, proofs=proofs, error=err,
                          again=sum(a for _, a in drawn)))
        j += per_call
    if on_card:
        torch.cuda.synchronize(dev)
    out = dict(rank=rank, card=card, t0=t0, t_end=t_end, key_s=key_s, calls=calls,
               witness_s=wtimes, vk=system.verifying_key(pk))
    if inst:
        inst.armed = False
        prof.stop()
        out["trace"] = _trace_stats(prof, inst, t0, t_end)
        del prof, inst
    if on_card:
        out["device_name"] = torch.cuda.get_device_name(card)
    if sampler:
        out["memory_used_peak"] = sampler.stop()
    dist.barrier()  # every rank's last call has returned before any check runs
    t = time.time()
    out["witness_check"] = check_witnesses(system, job, rank, calls, kept)
    out["witness_check"]["seconds"] = time.time() - t
    out["banned_modules"] = banned_modules()
    if fault == "exchange" and rank == world - 1:
        return None
    return out


def _trace_stats(prof, inst, t0: float, t_end: float) -> dict:
    from . import trace as T

    kernels = T.device_kernels(prof)
    marks = (T.COMMIT_MARK, T.NTT_MARK)
    work = [k for k in kernels if not any(m in k[0] for m in marks)]
    inside = [k for k in work if t0 <= k[2] < t_end]
    by_name: dict = {}
    for name, _s, _t, dur in inside:
        by_name[name] = by_name.get(name, 0.0) + dur
    commit_dev, commit_pairs = T.ranged_device_seconds(kernels, T.COMMIT_MARK, first=inst.sample)
    ntt_dev, ntt_pairs = T.ranged_device_seconds(kernels, T.NTT_MARK)
    commit_least, commit_ranges, ntt_least = inst.sampled_work()
    return dict(
        kernels=len(kernels),
        first_start=min((k[2] for k in kernels), default=None),
        launches=len(inside),
        busy_s=T.union_seconds([(k[2], k[3]) for k in inside], t0, t_end),
        top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        commit=dict(device_s=commit_dev, pairs=commit_pairs, least_s=commit_least,
                    ranges=commit_ranges, sample=inst.sample),
        ntt=dict(device_s=ntt_dev, pairs=ntt_pairs, least_s=ntt_least, ranges=len(inst.ntts)),
    )
