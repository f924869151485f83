"""Proving keys on disk (pk.to_bytes parity, ecdsa_p256.rs:261-270).

The port of the JAX package's plonk/pk_cache.py. Every ProvingKey tensor
goes into one .npz named by a digest of everything keygen's output
depends on: the format, the SRS (degree and tau seed), the constraint
system, the fixed assignment and the copy constraints. So a file made for
another circuit is never loaded.

The files hold the port's tensors as the prover consumes them: (8, *batch)
int32 words in Montgomery form with R = 2^256, not the JAX package's
33-limb arrays. The format tag is part of the digest and of the file, so
a JAX file is never loaded: `load_pk` refuses one. The files are named
`pk_k{k}_{digest}.torch.npz`.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..device import resolve
from ..fields.constants import BN254_FR
from ..fields.limbs import ints_to_words
from . import cs as CS
from .keygen import ProvingKey, VerifyingKey, _domain_for, keygen
from .srs import SRS

FORMAT = b"webauthn-halo2-tpu-torch-pk-v1"


def _cs_repr(cs: CS.ConstraintSystem) -> bytes:
    # the degree sets the extended domain and the number of h pieces
    return repr(
        (cs.degree(), cs.num_fixed, cs.num_advice, cs.num_instance,
         [(nm, str(g)) for nm, g in cs.gates],
         [(lk.name, [str(e) for e in lk.inputs], [str(e) for e in lk.tables])
          for lk in cs.lookups],
         cs.perm_columns)
    ).encode()


def pk_digest(k: int, cs: CS.ConstraintSystem, fixed_cols: list,
              copies: list, tau_seed: bytes = b"dev") -> str:
    """The cache key: the format, the SRS identity (k and tau seed) and the
    circuit description."""
    h = hashlib.blake2b(digest_size=16)
    h.update(FORMAT)
    h.update(k.to_bytes(4, "little"))
    h.update(b"srs-seed:")
    h.update(tau_seed)
    h.update(_cs_repr(cs))
    for col in fixed_cols:
        h.update(ints_to_words([int(v) % BN254_FR for v in col]).tobytes())
    h.update(repr(copies).encode())
    return h.hexdigest()


def synthesis_digest(cs: CS.ConstraintSystem, fixed_cols: list,
                     advice_cols: list, copies: list) -> str:
    """A digest of one synthesis: the constraint system, the fixed and
    advice assignments (each column's length and values) and the copy
    constraints. It reads only what both packages' circuit objects carry,
    so a build of one circuit from one witness has the same digest here and
    in the JAX package."""
    h = hashlib.blake2b(digest_size=32)
    h.update(_cs_repr(cs))
    for col in list(fixed_cols) + list(advice_cols):
        h.update(len(col).to_bytes(4, "little"))
        h.update(ints_to_words([int(v) % BN254_FR for v in col]).tobytes())
    h.update(repr(copies).encode())
    return h.hexdigest()


def _comms_bytes(comms: list) -> np.ndarray:
    """Affine (x, y) int pairs -> (m, 2, 32) little-endian bytes."""
    out = np.zeros((len(comms), 2, 32), dtype=np.uint8)
    for i, (x, y) in enumerate(comms):
        out[i, 0] = np.frombuffer(int(x).to_bytes(32, "little"), np.uint8)
        out[i, 1] = np.frombuffer(int(y).to_bytes(32, "little"), np.uint8)
    return out


def _comms_of(raw: np.ndarray) -> list:
    return [(int.from_bytes(raw[i, 0].tobytes(), "little"),
             int.from_bytes(raw[i, 1].tobytes(), "little"))
            for i in range(raw.shape[0])]


def _stack(cols: list, n: int) -> np.ndarray:
    if not cols:
        return np.zeros((8, 0, n), dtype=np.int32)
    return torch.stack(cols, dim=1).cpu().numpy()


def save_pk(path: str, pk: ProvingKey) -> None:
    vk = pk.vk
    n = vk.domain.n
    arrays = dict(
        format=np.frombuffer(FORMAT, np.uint8),
        fixed_lag=_stack(pk.fixed_lagrange, n),
        fixed_coeff=_stack(pk.fixed_coeff, n),
        fixed_ext=pk.fixed_ext.cpu().numpy(),
        sigma_lag=_stack(pk.sigma_lagrange, n),
        sigma_coeff=_stack(pk.sigma_coeff, n),
        sigma_ext=pk.sigma_ext.cpu().numpy(),
        indicators=torch.stack([pk.l0_ext, pk.llast_ext, pk.lblind_ext],
                               dim=1).cpu().numpy(),
        x_ext=pk.x_ext.cpu().numpy(),
        omega_mont=pk.omega_mont.cpu().numpy(),
        vk_fixed_comms=_comms_bytes(vk.fixed_commitments),
        vk_perm_comms=_comms_bytes(vk.perm_commitments),
        vk_repr=np.frombuffer(int(vk.transcript_repr).to_bytes(64, "little"),
                              np.uint8),
    )
    tmp = f"{path}.{os.getpid()}.tmp"  # concurrent writers never clobber
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_pk(path: str, srs: SRS, cs: CS.ConstraintSystem, device=None) -> ProvingKey:
    """A saved pk with its tensors on `device` (None: the current card),
    where the SRS must lie. Raises ValueError for a file of another format."""
    dev = resolve(device)
    if srs.g_lag.x.device != dev:
        raise ValueError(f"SRS lies on {srs.g_lag.x.device}, load_pk asked for {device}")
    with np.load(path) as z:
        if "format" not in z.files or z["format"].tobytes() != FORMAT:
            raise ValueError(f"{path} is not a proving key of this package's format")
        z = {name: z[name] for name in z.files}

    def dev_t(name: str) -> torch.Tensor:
        return torch.from_numpy(z[name]).to(dev)

    def cols(name: str) -> list:
        stack = dev_t(name)
        return [stack[:, i] for i in range(stack.shape[1])]

    domain = _domain_for(cs, srs.k)
    vk = VerifyingKey(domain, cs, _comms_of(z["vk_fixed_comms"]),
                      _comms_of(z["vk_perm_comms"]),
                      int.from_bytes(z["vk_repr"].tobytes(), "little"))
    l0_ext, llast_ext, lblind_ext = cols("indicators")
    return ProvingKey(vk, srs, dev, cols("fixed_lag"), cols("fixed_coeff"),
                      dev_t("fixed_ext"), cols("sigma_lag"), cols("sigma_coeff"),
                      dev_t("sigma_ext"), l0_ext, llast_ext, lblind_ext,
                      dev_t("x_ext"), dev_t("omega_mont"))


def pk_file(cache_dir: str, srs: SRS, cs: CS.ConstraintSystem, fixed_cols: list,
            copies: list) -> str:
    """The path of the circuit's key file in `cache_dir`."""
    digest = pk_digest(srs.k, cs, fixed_cols, copies, srs.tau_seed)
    return os.path.join(cache_dir, f"pk_k{srs.k}_{digest}.torch.npz")


def key_dir(cache_dir: str | None = None) -> str | None:
    """The directory a key is kept in: `cache_dir`, else $WH2_KEY_DIR (read
    at each call), else None, for a key kept in memory only. (The JAX
    package's default is keys/; the port writes no file unless asked.)"""
    return cache_dir or os.environ.get("WH2_KEY_DIR") or None


def keygen_cached(srs: SRS, cs: CS.ConstraintSystem, fixed_cols: list,
                  copies: list, cache_dir: str, device=None) -> ProvingKey:
    """keygen with a write-once file in `cache_dir` (the download_keys
    flow: generate once, then always load)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = pk_file(cache_dir, srs, cs, fixed_cols, copies)
    if os.path.exists(path):
        return load_pk(path, srs, cs, device=device)
    pk = keygen(srs, cs, fixed_cols, copies, device=device)
    save_pk(path, pk)
    return pk
