"""Where the port's entry points run.

Every public entry point takes `device=None`. None means the first CUDA
card, and raises when there is none: only an explicit `device="cpu"` runs
on the CPU, where every kernel wrapper takes its plain PyTorch version.
Constant tensors (twiddles, field constants) are kept per device here.
"""
from __future__ import annotations

import torch

_CACHE: dict = {}


def cached(key, make, device, dtype=None) -> torch.Tensor:
    """A constant tensor kept on `device`: `make()` (numpy) is copied over
    once per key and device. A copy from host memory waits for the stream,
    so constants used inside the prover's loops must not be remade."""
    ck = (key, str(device), dtype)
    t = _CACHE.get(ck)
    if t is None:
        t = torch.as_tensor(make()).to(device=device, dtype=dtype)
        _CACHE[ck] = t
    return t


def resolve(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
