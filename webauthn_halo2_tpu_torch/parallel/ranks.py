"""Spawn the ranks of a torch.distributed group on one host.

    results = run_ranks(fn, size, rendezvous_dir, backend="gloo", args=(...))

`torch.multiprocessing.spawn` starts each rank as a new process (the
spawn start method: a parent that has initialised CUDA cannot fork one),
raises a failed rank's traceback in the parent (every failing rank also
prints its own to its stderr), ends the other ranks and joins them all.
Each rank joins the default group of `size` ranks at a file rendezvous in
`rendezvous_dir` (a collective that waits longer than `timeout` seconds
fails), calls fn(rank, size, *args), leaves the group and writes what fn
returned (it must pickle; `fn` must be a module-level function) beside
the rendezvous. The results come back in rank order.

Backends: "nccl" for one rank a card, "gloo" for the CPU and for several
ranks sharing one card (parallel/sharded.py).
"""
from __future__ import annotations

import os
import pickle
import traceback
from datetime import timedelta

import torch.multiprocessing as tmp


def _result_path(rendezvous_dir: str, rank: int) -> str:
    return os.path.join(rendezvous_dir, f"result{rank}.pkl")


def _rank_main(rank: int, fn, size: int, backend: str, rendezvous_dir: str, args,
               timeout: float) -> None:
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{rendezvous_dir}/rendezvous",
                            rank=rank, world_size=size, timeout=timedelta(seconds=timeout))
    try:
        result = fn(rank, size, *args)
    except BaseException:
        # into this rank's own stderr: when one rank fails, the others' collectives
        # fail too, and the parent raises with whichever rank ended first
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    # a file, not a queue: a rank putting a large result on a pipe would wait
    # for a reader, and the parent reads only after every rank has ended
    with open(_result_path(rendezvous_dir, rank), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, size: int, rendezvous_dir: str, backend: str = "gloo",
              args: tuple = (), timeout: float = 600.0) -> list:
    """fn(rank, size, *args) in `size` spawned ranks; their results in rank order."""
    rendezvous_dir = os.path.abspath(rendezvous_dir)
    os.makedirs(rendezvous_dir, exist_ok=True)
    for name in ["rendezvous"] + [f"result{r}.pkl" for r in range(size)]:
        path = os.path.join(rendezvous_dir, name)
        if os.path.exists(path):  # a file store is used once; no stale results
            os.remove(path)
    tmp.spawn(_rank_main, args=(fn, size, backend, rendezvous_dir, args, timeout),
              nprocs=size, join=True)
    results = []
    for r in range(size):
        with open(_result_path(rendezvous_dir, r), "rb") as f:
            results.append(pickle.load(f))
    return results
