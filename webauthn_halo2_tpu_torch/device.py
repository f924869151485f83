"""Where the port's entry points run.

Every public entry point takes `device=None`. None, like "cuda", means
the calling thread's current CUDA card (card 0 unless
`torch.cuda.set_device` chose another), and raises when there is none:
only an explicit `device="cpu"` runs on the CPU, where every kernel
wrapper takes its plain PyTorch version. `resolve` always names the card
by its index, so a key, a stream or a constant made for "cuda" is the
same as one made for "cuda:0", and work handed to another thread stays on
its card. Each kernel wrapper launches on the card of its tensors, not on
the thread's current one (ops/kernels.on_card). Constant tensors
(twiddles, field constants) are kept per device here, and the tracing
switch and stream fence that the spans share.
"""
from __future__ import annotations

import os

import torch

_CACHE: dict = {}


def cached(key, make, device, dtype=None) -> torch.Tensor:
    """A constant tensor kept on `device`: `make()` (numpy) is copied over
    once per key and device. A copy from host memory waits for the stream,
    so constants used inside the prover's loops must not be remade. On a
    card the copy is finished before the tensor is kept, because provers
    on other streams read it too."""
    device = resolve(device)
    ck = (key, str(device), dtype)
    t = _CACHE.get(ck)
    if t is None:
        t = torch.as_tensor(make()).to(device=device, dtype=dtype)
        fence(t.device)
        _CACHE[ck] = t
    return t


def tracing() -> bool:
    """WH2_TRACE, read at each call: only under it do spans fence, record
    and print."""
    return bool(os.environ.get("WH2_TRACE"))


def fence(device: torch.device) -> None:
    """Wait for the work queued on the current stream of a CUDA device (the
    calling thread's stream, not the whole card); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def resolve(device=None) -> torch.device:
    """The device an entry point runs on, a card always with its index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
