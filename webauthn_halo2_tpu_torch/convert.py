"""Carry the JAX package's arrays, handed over as numpy, into port tensors.

The JAX package stores a field element as 33 lazy 8-bit limbs (int32) with
Montgomery R = 2^264; the port stores eight 32-bit words, fully reduced,
with R = 2^256. A Montgomery value moves across by one multiply:
montmul(x * 2^264, 2^248) = x * 2^264 * 2^248 / 2^256 = x * 2^256.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .fields.limbs import FQ_SPEC, W, FieldSpec
from .ops import ec as E
from .ops import modops as M
from .plonk.srs import L33, SRS, _normalize_host_limbs, load_srs


def field_from_jax(np_limbs33, spec: FieldSpec, mont: bool = True,
                   device=None, axis: int = 0) -> torch.Tensor:
    """(33, *batch) JAX limbs (limb axis `axis`) -> (8, *batch) port words,
    Montgomery form kept when mont=True."""
    arr = np.moveaxis(np.asarray(np_limbs33), axis, 0)
    if arr.shape[0] != L33:
        raise ValueError(f"expected 33 limbs on axis {axis}, got {arr.shape}")
    batch = arr.shape[1:]
    tight = _normalize_host_limbs(arr.reshape(L33, -1), spec.p).astype(np.int64)
    words = np.stack([tight[4 * i] | (tight[4 * i + 1] << 8)
                      | (tight[4 * i + 2] << 16) | (tight[4 * i + 3] << 24)
                      for i in range(W)])
    words = words.astype(np.uint32).view(np.int32).reshape((W,) + batch)
    t = torch.as_tensor(words).to(resolve(device))
    if mont:
        c = M.const(spec, 1 << 248, t.device, mont=False)
        t = M.montmul(spec, t, c.reshape((W,) + (1,) * len(batch)))
    return t


def point_from_jax(x, y, z, device=None) -> E.JPoint:
    """JAX Jacobian coordinates (33, n) over Fq -> port JPoint."""
    return E.JPoint(*(field_from_jax(c, FQ_SPEC, True, device) for c in (x, y, z)))


def srs_from_npz(path: str, device=None) -> SRS:
    """A JAX SRS file (plonk/srs.save_srs layout) -> port SRS."""
    return load_srs(path, device)
