"""Window arithmetic shared by the metric readers: what a run returned, by
request, and its percentiles."""
from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def calls(run: dict) -> list:
    return [c for r in run["ranks"] if r for c in r["calls"]]


def returned_latencies(run: dict) -> list:
    """The latency of every request whose proof came back inside the window:
    its call's return less the call's start."""
    return [c["t_ret"] - c["t_call"] for c in calls(run) if c["t_ret"] <= run["t_end"]
            for p in c["proofs"] if p]


def proof_equivalents(run: dict) -> float:
    """Proofs of the window: those returned in it, and of each call still
    running as it closed its proofs times the share of its time that lay
    inside it. A request that failed counts for nothing."""
    total = 0.0
    for c in calls(run):
        done = sum(1 for p in c["proofs"] if p)
        if c["t_ret"] <= run["t_end"]:
            total += done
        elif c["t_call"] < run["t_end"]:
            total += done * (run["t_end"] - c["t_call"]) / (c["t_ret"] - c["t_call"])
    return total


def traces(run: dict) -> list:
    return [r["trace"] for r in run["ranks"] if r and r.get("trace")]
