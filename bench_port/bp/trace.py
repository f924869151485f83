"""The traced run's instruments: ranges around the program's commitments
and NTTs, marked on the device, and the reading of torch.profiler's kernels.

A range is bounded on its CUDA stream by two marker kernels that the
program never launches: `torch.cuda._sleep` ("spin_kernel") for a
commitment, a float64 cosine ("cos_kernel") for an NTT. A stream runs its
kernels in order, so the kernels between a pair of markers are the range's.
The harness counts the least work of each range from its arguments
(roofline.py), which reads the same work whatever the program runs inside.
For commitments it counts the digits of the scalars, which needs a copy of
them: only the first proof on each stream (`sample` commitments, the count
one proof makes) is kept and counted, after the window.
"""
from __future__ import annotations

import threading

import torch

from . import roofline

COMMIT_MARK = "spin_kernel"
NTT_MARK = "cos_kernel"


class Instruments:
    """Wrappers put where the prover looks its commitments and transforms
    up; `armed` turns the markers on (the window), `sample` is the number
    of commitments one proof makes (counted in the warm-up)."""

    def __init__(self, device):
        self.device = device
        self.armed = False
        self.sample = None
        self.lock = threading.Lock()
        self.commits: dict = {}  # stream handle -> [(n, batch, words or None)]
        self.warm_commits: dict = {}
        self.ntts: list = []  # ntt_work dicts of the armed window
        self.local = threading.local()
        self._cos = None

    def install(self):
        self._cos = torch.ones(1, dtype=torch.float64, device=self.device)
        from webauthn_halo2_tpu_torch.ops import ntt as N
        from webauthn_halo2_tpu_torch.plonk import prover

        for name in ("commit_lagrange_batch", "commit_coeff_batch", "commit_coeff"):
            setattr(prover, name, self._commit(getattr(prover, name)))
        for name in ("ntt", "intt"):
            setattr(N, name, self._ntt(getattr(N, name)))

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def _commit(self, fn):
        def wrapped(srs, cols):
            listed = isinstance(cols, (list, tuple))
            if listed and not cols:
                return fn(srs, cols)
            if not self.armed:
                with self.lock:
                    self.warm_commits.setdefault(self._stream(), []).append(1)
                return fn(srs, cols)
            n = cols[0].shape[-1] if listed else cols.shape[-1]
            batch = len(cols) if listed else (cols.shape[1] if cols.dim() == 3 else 1)
            s = self._stream()
            with self.lock:
                seen = self.commits.setdefault(s, [])
                keep = self.sample is not None and len(seen) < self.sample
                seen.append((n, batch, None))
            if keep:  # a copy of the scalars, made outside the range
                seen[-1] = (n, batch, torch.stack(list(cols), dim=1) if listed else cols.clone())
            torch.cuda._sleep(1)
            out = fn(srs, cols)
            torch.cuda._sleep(1)
            return out
        return wrapped

    def _ntt(self, fn):
        def wrapped(spec, a, k):
            depth = getattr(self.local, "depth", 0)
            if not self.armed or depth:
                self.local.depth = depth + 1
                try:
                    return fn(spec, a, k)
                finally:
                    self.local.depth = depth
            B = 1 if a.dim() == 2 else a.shape[1]
            with self.lock:
                self.ntts.append(roofline.ntt_work(B, k))
            self.local.depth = 1
            try:
                self._mark_ntt()
                out = fn(spec, a, k)
                self._mark_ntt()
            finally:
                self.local.depth = 0
            return out
        return wrapped

    def _mark_ntt(self):
        self._cos.cos_()

    def commits_per_proof(self) -> int:
        """Commitments a stream made in the warm-up, where each stream
        proved once."""
        counts = {len(v) for v in self.warm_commits.values()}
        return counts.pop() if len(counts) == 1 else None

    def sampled_work(self) -> tuple:
        """(least seconds of the sampled commitments, their count) and the
        least seconds of every armed NTT."""
        least, count = 0.0, 0
        for seen in self.commits.values():
            for n, batch, words in seen[: self.sample or 0]:
                if words is None:
                    continue
                least += roofline.bound_s(roofline.msm_work(
                    n, batch, roofline.nonzero_digits(words, n)))
                count += 1
        return least, count, sum(roofline.bound_s(w) for w in self.ntts)


def _ev(e, ns_name, us_name):
    if hasattr(e, ns_name):
        return getattr(e, ns_name)() / 1e9
    return getattr(e, us_name)() / 1e6


def device_kernels(prof) -> list:
    """(name, stream, start s, duration s) of each kernel the profiler saw,
    start on the profiler's clock (seconds since the epoch), memory copies
    and sets left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split(".")[-1] != "CUDA":
            continue
        name = e.name()
        if name.startswith(("Memcpy", "Memset")):
            continue
        out.append((name, e.device_resource_id(), _ev(e, "start_ns", "start_us"),
                    _ev(e, "duration_ns", "duration_us")))
    return out


def union_seconds(spans: list, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the (start, duration) spans cover."""
    total, end = 0.0, lo
    for s, d in sorted(spans):
        s, e = max(s, end), min(s + d, hi)
        if e > s:
            total += e - s
            end = e
    return total


def ranged_device_seconds(kernels: list, mark: str, first: int | None = None) -> tuple:
    """Seconds of the kernels between pairs of `mark` kernels on each stream
    (only each stream's `first` pairs where given) and the pairs counted;
    an unclosed pair is left out."""
    by_stream: dict = {}
    for name, stream, start, dur in kernels:
        by_stream.setdefault(stream, []).append((start, name, dur))
    total, pairs = 0.0, 0
    for evs in by_stream.values():
        evs.sort()
        inside, acc, done = False, 0.0, 0
        for _, name, dur in evs:
            if first is not None and done >= first:
                break
            if mark in name:
                if inside:
                    total += acc
                    pairs += 1
                    done += 1
                inside, acc = not inside, 0.0
            elif inside and COMMIT_MARK not in name and NTT_MARK not in name:
                acc += dur
        # an open range at the end is not counted
    return total, pairs
