"""commit_roofline: the least time of the sampled commitments (the first
proof on each prover stream of each rank; the work of an MSM of their own
scalars' nonzero digits, bp/roofline.py) over the device time of the
kernels launched inside their ranges."""
from bp.stats import traces


def read(run):
    least = dev = 0.0
    for t in traces(run):
        c = t["commit"]
        if not c["sample"] or c["pairs"] != c["ranges"]:
            return None
        least += c["least_s"]
        dev += c["device_s"]
    return 100.0 * least / dev if dev else None
