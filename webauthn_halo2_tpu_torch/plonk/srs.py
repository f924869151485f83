"""KZG structured reference string: load the committed dev SRS.

The SRS files (`artifacts/srs_bn254_k{k}_{seed hex}.npz`) hold the JAX
package's tensors: (3, 33, n) Jacobian coordinates in lazy 8-bit limbs with
Montgomery R = 2^264, plus the G2 points as ints. Loading normalises the
limbs on the host and re-encodes them as the port's words with
R = 2^256 (see convert.py). Device SRS generation is not ported yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..device import resolve
from ..ops import ec as E

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                                 "artifacts")

L33 = 33  # the JAX package's limbs per element
B8 = 8
MASK8 = (1 << B8) - 1


@dataclass
class SRS:
    k: int
    tau_seed: bytes
    g_mono: E.JPoint  # [tau^i G], Montgomery affine words (8, n)
    g_lag: E.JPoint  # [L_i(tau) G]
    g2: tuple
    s_g2: tuple

    @property
    def n(self) -> int:
        return 1 << self.k


def _normalize_host_limbs(a: np.ndarray, p: int) -> np.ndarray:
    """Exact host normalisation of lazy (33, n) limb arrays to canonical
    tight limbs (< p, every limb <= 255)."""
    a = a.astype(np.int64)
    out = np.empty_like(a)
    carry = np.zeros(a.shape[1:], dtype=np.int64)
    for i in range(L33):
        v = a[i] + carry
        out[i] = v & MASK8
        carry = v >> B8
    if carry.any():
        raise ValueError("limb value beyond 2^264: not a JAX field tensor")
    p_l = np.array([(p >> (B8 * i)) & MASK8 for i in range(L33)], dtype=np.int64)
    # a lazy value is below a small multiple of p: subtract p while >= p
    for _ in range(64):
        ge = np.ones(a.shape[1:], dtype=bool)
        decided = np.zeros(a.shape[1:], dtype=bool)
        for i in range(L33 - 1, -1, -1):
            gt = ~decided & (out[i] > p_l[i])
            lt = ~decided & (out[i] < p_l[i])
            ge = np.where(lt, False, ge)
            decided |= gt | lt
        if not ge.any():
            break
        borrow = np.zeros(a.shape[1:], dtype=np.int64)
        for i in range(L33):
            v = out[i] - np.where(ge, p_l[i], 0) - borrow
            borrow = (v < 0).astype(np.int64)
            out[i] = np.where(ge, v + (borrow << B8), out[i])
    return out.astype(np.int32)


def load_srs(path: str, device=None) -> SRS:
    from ..convert import point_from_jax

    dev = resolve(device)
    z = np.load(path, allow_pickle=True)
    g2 = z["g2"]
    sg2 = z["s_g2"]
    return SRS(
        int(z["k"]),
        bytes(z["seed"].tobytes()),
        point_from_jax(*z["g_mono"], device=dev),
        point_from_jax(*z["g_lag"], device=dev),
        (tuple(int(v) for v in g2[0]), tuple(int(v) for v in g2[1])),
        (tuple(int(v) for v in sg2[0]), tuple(int(v) for v in sg2[1])),
    )


_SRS_MEM_CACHE: dict = {}


def get_srs(k: int, seed: bytes = b"dev", cache_dir: str | None = None,
            device=None) -> SRS:
    """Load the committed SRS for degree k (kept in memory per device)."""
    dev = resolve(device)
    key = (k, seed, str(dev))
    if key in _SRS_MEM_CACHE:
        return _SRS_MEM_CACHE[key]
    cache_dir = cache_dir or os.path.abspath(DEFAULT_CACHE_DIR)
    path = os.path.join(cache_dir, f"srs_bn254_k{k}_{seed.hex()}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: device SRS generation is not ported; only the "
            "committed SRS files load")
    srs = load_srs(path, dev)
    _SRS_MEM_CACHE[key] = srs
    return srs
