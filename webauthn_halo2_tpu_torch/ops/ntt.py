"""Radix-2 NTT over bn254 Fr word tensors (the prover's FFT engine).

Conventions follow ops/ntt.py of the JAX package (PSE halo2 domain): the
forward NTT maps coefficients to evaluations on H = <omega> of size
n = 2^k in natural order; the inverse divides by n. The schedule is
decimation in time after a bit-reversal gather.

Layout: a polynomial is (8, n), a stack of them (8, B, n); the transform
runs along the last axis.

On a CUDA tensor `ntt`/`intt` go to the fused kernels for every k:
the bit-reversal gather is a torch index op, stage A (csrc/ntt.cu) runs
all stages with pair distance h < T inside shared memory (the tile of a
block, or of a cluster of blocks), in passes of radix 4, stage B runs each
remaining stage, and the inverse scales by n^-1 through the montmul
kernel; `stage_a_schedule` picks the tiles. On a CPU tensor they run
`_ntt_core`, the stage loop, which is the plain version of the whole
transform.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import cached
from ..fields.constants import BN254_FR, BN254_FR_ROOT_OF_UNITY, BN254_FR_S
from ..fields.limbs import FR_SPEC, W, FieldSpec
from . import kernels as K
from . import modops as M

T_LOG_MAX = 12  # stage-A block tile of 4096 elements: 128 KB of shared memory
STAGE_A_R = 2  # csrc/ntt.cu: passes of radix 4, four elements a thread
CLUSTER_LOG_MAX = 2  # clusters of up to 4 blocks share a tile
# The schedule: blocks of 2^10 elements in clusters of 2, one tile of 2^11
# (scripts/sweep_torch_kernels.py on the proof's launch shapes, PERF.md).
T_LOG_BLOCK = 10
CLUSTER_LOG = 1

LAUNCHES = {"ntt_stage_a": 0, "ntt_stage_b": 0}


def root_of_unity(k: int, p: int = BN254_FR, base: int = BN254_FR_ROOT_OF_UNITY,
                  s: int = BN254_FR_S) -> int:
    """Primitive 2^k-th root of unity in Fr (squares of the 2^S root)."""
    assert k <= s
    w = base
    for _ in range(s - k):
        w = w * w % p
    return w


@functools.lru_cache(maxsize=None)
def _bitrev_perm(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _twiddle_table(k: int, inverse: bool) -> np.ndarray:
    """(8, n - 1) Montgomery words: the per-stage twiddle tables of the JAX
    package's `_stage_twiddles` laid end to end. Stage s (half-block
    h = 2^s) owns entries [h - 1, 2h - 1); entry h - 1 + j = w^(j n / 2h)."""
    p = BN254_FR
    n = 1 << k
    w = root_of_unity(k)
    if inverse:
        w = pow(w, p - 2, p)
    vals = []
    for stage in range(1, k + 1):
        h = 1 << (stage - 1)
        ws = pow(w, n >> stage, p)
        acc = 1
        for _ in range(h):
            vals.append(acc)
            acc = acc * ws % p
    if not vals:
        return np.zeros((W, 0), dtype=np.int32)
    return FR_SPEC.encode(vals)


def _stage_twiddles(k: int, inverse: bool) -> list[np.ndarray]:
    """Per-stage (8, h) Montgomery twiddles, stage m = 1..k."""
    tab = _twiddle_table(k, inverse)
    return [tab[:, (1 << s) - 1:(2 << s) - 1] for s in range(k)]


def _twiddles_dev(k: int, inverse: bool, device) -> torch.Tensor:
    return cached(("tw", k, inverse), lambda: _twiddle_table(k, inverse), device)


def _perm_dev(k: int, device) -> torch.Tensor:
    return cached(("perm", k), lambda: _bitrev_perm(k), device)


def _as_stack(a: torch.Tensor):
    """(8, n) or (8, B, n) -> ((8, B, n), squeeze flag)."""
    if a.ndim == 2:
        return a[:, None, :], True
    if a.ndim != 3 or a.shape[0] != W:
        raise ValueError(f"ntt takes (8, n) or (8, B, n), got {tuple(a.shape)}")
    return a, False


def _butterfly_stage(spec, x, tw, s: int, mm):
    """One DIT stage with half-block h = 2^s on (8, B, n)."""
    _, B, n = x.shape
    h = 1 << s
    xr = x.reshape(W, B, n // (2 * h), 2, h)
    lo, hi = xr[:, :, :, 0, :], xr[:, :, :, 1, :]
    w = tw[:, h - 1:2 * h - 1].reshape(W, 1, 1, h)
    t = mm(spec, w, hi)
    return torch.stack([M.add(spec, lo, t), M.sub(spec, lo, t)],
                       dim=3).reshape(W, B, n)


def _ntt_core(spec: FieldSpec, a: torch.Tensor, k: int, inverse: bool,
              plain: bool = False) -> torch.Tensor:
    """The stage loop: the plain version of `ntt`/`intt` (any device).
    plain=True keeps every multiply in plain PyTorch on a CUDA tensor too."""
    mm = M.montmul_plain if plain else M.montmul
    x, squeeze = _as_stack(a)
    n = 1 << k
    assert x.shape[2] == n
    x = x[:, :, _perm_dev(k, x.device)]
    tw = _twiddles_dev(k, inverse, x.device)
    for s in range(k):
        x = _butterfly_stage(spec, x, tw, s, mm)
    if inverse:
        x = mm(spec, x, _ninv(spec, k, x.device))
    return x[:, 0] if squeeze else x


def _ninv(spec: FieldSpec, k: int, device) -> torch.Tensor:
    n = 1 << k
    return M.const(spec, pow(n, spec.p - 2, spec.p), device).reshape(W, 1, 1)


# --- stage A: every block-local stage (h < T) ---------------------------

def stage_a_schedule(B: int, k: int) -> tuple[int, int]:
    """(log_t, cq) of stage A for a transform of B columns of 2^k: stage A
    runs stages 0 .. log_t - 1, in blocks of 2^(log_t - cq - 2) threads
    over tiles of 2^(log_t - cq) elements, clusters of 2^cq blocks sharing
    the stages above the block's tile; (0, 0) (no stage A) below k = 3.
    One schedule fits every shape of the proof: a single column of 2^17
    still has 128 blocks for the 132 SMs, and against the best schedule of
    each launch shape it lost at most 1.5% of stage A + B on an H100."""
    if k < 3:
        return 0, 0
    log_b = min(k, T_LOG_BLOCK)
    cq = min(CLUSTER_LOG, k - log_b)
    return log_b + cq, cq


def stage_a_passes(log_t: int) -> list[tuple[int, int, int]]:
    """The passes of a stage-A block over its tile of 2^log_t elements,
    (c, s, e) each: thread g holds the four elements
    ((g >> c) << (c + 2)) | (k << c) | (g mod 2^c) and runs stages
    s .. e - 1 (a subset of c, c + 1) on them."""
    R = STAGE_A_R
    return [(min(s, log_t - R), s, min(s + R, log_t)) for s in range(0, log_t, R)]


def stage_a_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                  log_t: int) -> torch.Tensor:
    """Plain version of the stage-A kernel: x (8, B, n) bit-reversed,
    cut into tiles of T = 2^log_t that run stages h = 1 .. T/2 alone."""
    _, B, n = x.shape
    T = 1 << log_t
    tiles = x.reshape(W, B * (n // T), T)
    for s in range(log_t):
        tiles = _butterfly_stage(spec, tiles, tw, s, M.montmul_plain)
    return tiles.reshape(W, B, n)


def stage_a(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
            log_t: int, cq: int = 0) -> torch.Tensor:
    """Stage A of csrc/ntt.cu on a CUDA tensor, its plain version on CPU:
    stages 0 .. log_t - 1, with block tiles of 2^(log_t - cq) in clusters
    of 2^cq blocks (which changes the kernel's schedule, not its result)."""
    if x.device.type == "cpu":
        return stage_a_plain(spec, x, tw, log_t)
    _check_stage_args(x, tw)
    _, B, n = x.shape
    log_b = log_t - cq
    if (n % (1 << log_t) or not 3 <= log_b <= T_LOG_MAX
            or not 0 <= cq <= CLUSTER_LOG_MAX):
        raise ValueError(f"stage A: bad tile 2^{log_b} or cluster 2^{cq} for n={n}")
    if x.data_ptr() % 16:
        raise ValueError("stage A reads 16-byte words: x must be 16-byte aligned")
    out = torch.empty_like(x)
    with K.on_card(x.device) as stream:
        rc = K.lib("ntt").wh2_ntt_stage_a(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw.shape[1], B, n,
            log_b, cq, K.modulus_words(spec), spec.n0, stream)
    K.check(rc, "ntt stage A kernel")
    LAUNCHES["ntt_stage_a"] += 1
    return out


# --- stage B: one cross-block stage (h >= T) -----------------------------

def stage_b_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
                  s: int) -> torch.Tensor:
    """Plain version of the stage-B kernel: one stage, h = 2^s."""
    return _butterfly_stage(spec, x, tw, s, M.montmul_plain)


def stage_b(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor,
            s: int) -> torch.Tensor:
    """Stage B of csrc/ntt.cu on a CUDA tensor, its plain version on CPU."""
    if x.device.type == "cpu":
        return stage_b_plain(spec, x, tw, s)
    _check_stage_args(x, tw)
    _, B, n = x.shape
    if not (1 << s) < n:
        raise ValueError(f"stage B: h=2^{s} out of range for n={n}")
    out = torch.empty_like(x)
    with K.on_card(x.device) as stream:
        rc = K.lib("ntt").wh2_ntt_stage_b(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw.shape[1], B, n, s,
            K.modulus_words(spec), spec.n0, stream)
    K.check(rc, "ntt stage B kernel")
    LAUNCHES["ntt_stage_b"] += 1
    return out


def _check_stage_args(x: torch.Tensor, tw: torch.Tensor) -> None:
    K.card_of("the NTT kernels", x, tw)
    if x.dtype != torch.int32 or tw.dtype != torch.int32:
        raise TypeError("ntt stages take int32 word tensors")
    if x.ndim != 3 or x.shape[0] != W or not x.is_contiguous():
        raise ValueError(f"ntt stages take contiguous (8, B, n), got {tuple(x.shape)}")
    if not tw.is_contiguous() or tw.shape[1] < x.shape[2] - 1:
        raise ValueError("ntt stages need the (8, n - 1) twiddle table")


def ntt_fused(spec: FieldSpec, a: torch.Tensor, k: int, inverse: bool = False,
              t_lanes: int = 0) -> torch.Tensor:
    """Bit-reversal gather, stage A, stage B per remaining stage, and the
    n^-1 scale for the inverse: (8, n) or (8, B, n). Stage A's tile comes
    from `stage_a_schedule`, or is t_lanes elements where that is given."""
    if spec.p != BN254_FR:
        raise ValueError("NTT domain only defined over bn254 Fr")
    x, squeeze = _as_stack(a)
    n = 1 << k
    assert x.shape[2] == n
    log_t, cq = stage_a_schedule(x.shape[1], k)
    if t_lanes:
        log_t, cq = min(k, t_lanes.bit_length() - 1), 0
    x = x[:, :, _perm_dev(k, x.device)].contiguous()
    tw = _twiddles_dev(k, inverse, x.device)
    if log_t:
        x = stage_a(spec, x, tw, log_t, cq)
    for s in range(log_t, k):
        x = stage_b(spec, x, tw, s)
    if inverse:
        x = M.montmul(spec, x, _ninv(spec, k, x.device))
    return x[:, 0] if squeeze else x


def ntt(spec: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations on H (natural order)."""
    if a.device.type == "cpu":
        return _ntt_core(spec, a, k, False)
    return ntt_fused(spec, a, k, False)


def intt(spec: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients."""
    if a.device.type == "cpu":
        return _ntt_core(spec, a, k, True)
    return ntt_fused(spec, a, k, True)


@functools.lru_cache(maxsize=None)
def _power_table(g: int, n: int) -> np.ndarray:
    """(8, n) Montgomery words of [g^0, g^1, ..., g^(n-1)]."""
    powers = []
    acc = 1
    for _ in range(n):
        powers.append(acc)
        acc = acc * g % BN254_FR
    return FR_SPEC.encode(powers)


def coset_shift(spec: FieldSpec, a: torch.Tensor, g: int) -> torch.Tensor:
    """Scale coefficient i by g^i along the last axis."""
    n = a.shape[-1]
    pw = cached(("pow", g, n), lambda: _power_table(g, n), a.device)
    if a.ndim == 3:
        pw = pw[:, None, :]
    return M.montmul(spec, a, pw)
