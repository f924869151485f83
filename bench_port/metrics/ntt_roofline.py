"""ntt_roofline: the least time of every NTT and inverse NTT of the window
(bp/roofline.ntt_work of its shape) over the device time of the kernels
launched inside their ranges."""
from bp.stats import traces


def read(run):
    least = dev = 0.0
    for t in traces(run):
        c = t["ntt"]
        if c["pairs"] != c["ranges"]:
            return None
        least += c["least_s"]
        dev += c["device_s"]
    return 100.0 * least / dev if dev else None
