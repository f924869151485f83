"""Spawn the ranks of a torch.distributed group, on one host or several.

    results = run_ranks(fn, size, rendezvous_dir, backend="gloo", args=(...))

`torch.multiprocessing.spawn` starts each of this host's `size` ranks as
a new process (the spawn start method: a parent that has initialised CUDA
cannot fork one), raises a failed rank's error in the parent, naming its
rank (every failing rank also prints its traceback to its stderr), ends
the other ranks and joins them all. Each rank joins the default group (a
collective that waits longer than `timeout` seconds fails), calls
fn(rank, world, *args), leaves the group and writes what fn returned (it
must pickle; `fn` must be a module-level function) beside the rendezvous.
The results of this host's ranks come back in rank order.

One host: a file rendezvous in `rendezvous_dir`, ranks 0..size-1. Several
hosts (`coordinator="host:port"`, `num_hosts`, `host_id`): every host runs
run_ranks with the same `size` and a directory of its own for the
results; the group meets at tcp://host:port, which host 0 serves (its
rank 0 holds the store), and host h holds the global ranks h * size ..
h * size + size - 1 (`global_ranks`). Each rank finds its rank on this
host in LOCAL_RANK, as under torchrun (also RANK, WORLD_SIZE and
LOCAL_WORLD_SIZE).

Backends: "nccl" for one rank a card, "gloo" for the CPU and for several
ranks sharing one card (parallel/sharded.py, parallel/batch.py).
"""
from __future__ import annotations

import os
import pickle
import traceback
from datetime import timedelta

import torch.multiprocessing as tmp


def global_ranks(host_id: int, num_hosts: int, local_ranks: int) -> tuple[list[int], int]:
    """The global ranks of a host's local ranks 0..local_ranks-1, in that
    order, and the world size: host h holds h * local_ranks + local rank."""
    if not 0 <= host_id < num_hosts or local_ranks < 1:
        raise ValueError(f"host {host_id} of {num_hosts} with {local_ranks} local ranks")
    first = host_id * local_ranks
    return list(range(first, first + local_ranks)), num_hosts * local_ranks


def init_method(rendezvous_dir: str, coordinator: str | None = None) -> str:
    """The group's rendezvous: tcp://host:port for several hosts, else a
    file in rendezvous_dir."""
    if coordinator:
        host, sep, port = coordinator.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"coordinator {coordinator!r} is not host:port")
        return f"tcp://{coordinator}"
    return f"file://{rendezvous_dir}/rendezvous"


def _result_path(rendezvous_dir: str, local_rank: int) -> str:
    return os.path.join(rendezvous_dir, f"result{local_rank}.pkl")


def _rank_main(local_rank: int, fn, ranks: list, world: int, backend: str, method: str,
               rendezvous_dir: str, args, timeout: float) -> None:
    import torch.distributed as dist

    rank = ranks[local_rank]
    os.environ.update(LOCAL_RANK=str(local_rank), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(len(ranks)))
    dist.init_process_group(backend, init_method=method, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))
    try:
        result = fn(rank, world, *args)
    except Exception as e:
        # into this rank's own stderr: when one rank fails, the others' collectives
        # fail too, and the parent raises with whichever rank ended first
        traceback.print_exc()
        raise RuntimeError(f"rank {rank} failed: {type(e).__name__}: {e}") from e
    finally:
        dist.destroy_process_group()
    # a file, not a queue: a rank putting a large result on a pipe would wait
    # for a reader, and the parent reads only after every rank has ended
    with open(_result_path(rendezvous_dir, local_rank), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, size: int, rendezvous_dir: str, backend: str = "gloo",
              args: tuple = (), timeout: float = 600.0, coordinator: str | None = None,
              num_hosts: int = 1, host_id: int = 0) -> list:
    """fn(rank, world, *args) in this host's `size` spawned ranks; their
    results in rank order."""
    rendezvous_dir = os.path.abspath(rendezvous_dir)
    ranks, world = global_ranks(host_id, num_hosts, size)
    method = init_method(rendezvous_dir, coordinator)
    os.makedirs(rendezvous_dir, exist_ok=True)
    for name in ["rendezvous"] + [f"result{r}.pkl" for r in range(size)]:
        path = os.path.join(rendezvous_dir, name)
        if os.path.exists(path):  # a file store is used once; no stale results
            os.remove(path)
    tmp.spawn(_rank_main, args=(fn, ranks, world, backend, method, rendezvous_dir, args,
                                timeout), nprocs=size, join=True)
    results = []
    for r in range(size):
        with open(_result_path(rendezvous_dir, r), "rb") as f:
            results.append(pickle.load(f))
    return results
