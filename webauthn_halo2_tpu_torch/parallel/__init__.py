"""Proving over several ranks of torch.distributed: one proof sharded over
the ranks (sharded.py), N independent proofs shared round robin over them
(batch.py), and the spawning of the ranks on one host or several
(ranks.py)."""
