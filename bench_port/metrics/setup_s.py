"""setup_s: seconds from the benchmark process's start until the window
opens: the ranks spawned, kernels loaded, SRS and key loaded (or made, in a
checkout's first run) and each rank's warm-up call proved."""


def read(run):
    return run["setup_s"]
