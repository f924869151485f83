"""witness_s.p50: the median seconds of a request's witness (the callable
the harness hands to `api.prove_batch`, timed by its own wrapper), over all
requests of the window."""
from bp.stats import percentile


def read(run):
    t = [s for r in run["ranks"] if r for s in r["witness_s"]]
    return percentile(t, 50) if t else None
