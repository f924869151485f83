"""proofs_per_s: the proofs of the window, over all ranks, per second of
it: every proof returned inside the window, and of each call still running
as the window closed its proofs times the share of its time that lay
inside the window (its work in the window, not its return; the calls of a
rank run back to back from the window's start). A failed request counts as
not returned."""
from bp.stats import proof_equivalents


def read(run):
    return proof_equivalents(run) / run["seconds"]
