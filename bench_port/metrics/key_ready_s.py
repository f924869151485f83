"""key_ready_s: seconds of rank 0's `api.proving_key` in set-up (the SRS,
the circuit's synthesis and the key file), on the harness's clock."""


def read(run):
    return run["ranks"][0]["key_s"] if run["ranks"][0] else None
