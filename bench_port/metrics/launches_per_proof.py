"""launches_per_proof: device kernels (the profiler's, every rank, started
inside the window; the harness's range markers left out) over the proofs of
the window, a call still running at its close counted by its share of time
inside it."""
from bp.stats import proof_equivalents, traces


def read(run):
    tr = traces(run)
    proofs = proof_equivalents(run)
    if not tr or not proofs:
        return None
    return sum(t["launches"] for t in tr) / proofs
