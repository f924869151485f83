"""pool_latency_p90_s: the 90th percentile of the latency of every request
returned inside the window, over all ranks (from its call's start to the
call's return). Both proofs of a call share its latency, and each rank's
first call starts with the window, so a 51 s window gives some tens of
values at k=17 and about six at k=19: a reading of the pool, not a tail
that a wallet could be promised."""
from bp.stats import percentile, returned_latencies


def read(run):
    lat = returned_latencies(run)
    return percentile(lat, 90) if lat else None
