"""Proving over several ranks of torch.distributed (sharded.py) and the
spawning of such ranks (ranks.py)."""
