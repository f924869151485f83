"""Data-parallel proving: N independent proofs shared round robin over the
ranks of a torch.distributed group.

The port of the JAX system's multi-host launch path
(scripts/launch_multihost.py, BASELINE config 5: batched multi-signature
proving across hosts). Each rank proves its shard of the N witnesses,
`i % size == rank` (`shard`), through `api.prove_batch` on its own card
and verifies every proof it made with the native verifier. No collective
runs inside a proof: the ranks meet only at the end of `prove_shard`,
which gathers to every rank each rank's indices, the sha256 of each of
its proofs, its seconds and its key's `transcript_repr`. Every rank keys
from the same deterministic SRS (or loads one key file), so the ranks'
keys must be one: a rank whose key differs, or whose proof does not
verify, makes every rank raise, naming it. This is the JAX script's
determinism check across hosts (its `vk_digest`).

Devices: a rank's card is `sharded.make_mesh(group, device).device`:
device=None means cuda:(rank % cards), which is the local rank modulo
the host's cards under parallel/ranks.py's layout, and raises without a
card; only an explicit "cpu" runs on the CPU.

Backends: only small Python objects cross between ranks
(`all_gather_object`), so gloo serves any layout of ranks and cards; NCCL
is taken only when the caller asks for it, one rank a card (make_mesh
refuses two ranks on one card first). The prover hooks of sharded.py
assume every rank proves the same inputs, so `prove_shard` refuses to
run under WH2_SHARDED=1.
"""
from __future__ import annotations

import contextlib
import hashlib
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import api
from ..plonk.verifier import verify_proof
from . import sharded


def shard(n: int, rank: int, size: int) -> list[int]:
    """The indices of N items that `rank` of `size` takes: i % size == rank."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not in a group of {size}")
    return list(range(rank, n, size))


def seeded_rng(seed: bytes):
    """A deterministic prover rng: rng(nbytes) is the blake2b of the seed
    and a call counter. The same seed gives the same proof on any rank."""
    ctr = [0]

    def rng(nbytes: int) -> bytes:
        ctr[0] += 1
        return hashlib.blake2b(seed + ctr[0].to_bytes(8, "little"),
                               digest_size=nbytes).digest()

    return rng


@dataclass
class Shard:
    """What `prove_shard` gives each rank: its own proofs, and every rank's
    record in rank order (`rank`, `host`, `device`, `indices`, `digests`
    (sha256 hex of each proof, in the order of `indices`), `prove_s` (the
    shard's `prove_batch`, timed from a barrier that every rank passes
    together), `verify_s`, `vk` (the key's transcript_repr) and
    `peak_bytes` (the card's peak allocation since the caller last reset
    it; None on the CPU))."""
    rank: int
    size: int
    proofs: dict
    ranks: list

    @property
    def digests(self) -> dict:
        """Every index's proof digest, over all ranks."""
        return {i: d for r in self.ranks for i, d in zip(r["indices"], r["digests"])}


def prove_shard(pk, witnesses: list, rngs: list | None = None, group=None) -> Shard:
    """Prove this rank's shard of `witnesses` (callables returning (advice,
    instances), as `api.prove_batch` takes them; every rank passes all N,
    and `rngs[i]` goes with witness i) with SHPLONK over Blake2b, as
    `api.generate_proofs_batch` does, verify each proof, gather every
    rank's record to every rank and check them: the indices cover 0..N-1
    once, one key across the ranks, every proof verified. Every rank of
    `group` (None: the default group) calls it."""
    if sharded._sharded():
        raise ValueError("WH2_SHARDED=1 shards one proof over the ranks, which "
                         "then must prove the same inputs: unset it for data-parallel proving")
    if rngs is not None and len(rngs) != len(witnesses):
        raise ValueError(f"{len(rngs)} rngs for {len(witnesses)} witnesses")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    mine = shard(len(witnesses), rank, size)
    instances = {}

    def keeping_instances(i):
        def run():
            advice, inst = witnesses[i]()
            instances[i] = inst
            return advice, inst
        return run

    dev = pk.device
    # an object collective of NCCL stages through the current card
    on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with on_card:
        dist.barrier(group)
    t0 = time.perf_counter()
    proofs = api.prove_batch(pk, [keeping_instances(i) for i in mine],
                             rngs=[rngs[i] for i in mine] if rngs is not None else None)
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    invalid = [i for i, p in zip(mine, proofs)
               if not verify_proof(pk.vk, pk.srs, p, instances[i])]
    verify_s = time.perf_counter() - t0
    record = dict(rank=rank, host=socket.gethostname(), device=str(dev), indices=mine,
                  digests=[hashlib.sha256(p).hexdigest() for p in proofs],
                  invalid=invalid, prove_s=prove_s, verify_s=verify_s,
                  vk=pk.vk.transcript_repr,
                  peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    records = [None] * size
    with on_card:
        dist.all_gather_object(records, record, group=group)
    bad = {r["rank"]: r["invalid"] for r in records if r["invalid"]}
    if bad:
        raise RuntimeError(f"proofs that do not verify, by rank: {bad}")
    vks = {r["vk"] for r in records}
    if len(vks) != 1:
        raise RuntimeError("the ranks hold different keys: " + ", ".join(
            f"rank {r['rank']} vk {r['vk']:#x}" for r in records))
    covered = sorted(i for r in records for i in r["indices"])
    if covered != list(range(len(witnesses))):
        raise RuntimeError(f"the ranks proved {covered}, not 0..{len(witnesses) - 1} once each")
    return Shard(rank, size, dict(zip(mine, proofs)), records)
