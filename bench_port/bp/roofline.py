"""The benchmark's yardstick for a kernel's share of its roofline: the
H100's ceilings and the least work of an MSM and of an NTT, frozen from the
program's `utils/roofline.py` (its `msm_work`, `ntt_work` and digit count)
so that a later change to the program cannot move it.

A field element is eight 32-bit words; arithmetic is counted in 32-bit
integer multiply-adds (IMAD). A bound is the larger of the bytes a call must
move over the memory rate and its operations over their rate.
"""
from __future__ import annotations

import torch

from .plain import BN_R

# H100 SXM (NVIDIA data sheet, dense): HBM bytes/s; 32-bit IMADs/s are half
# the 67 TFLOP/s float32 rate counted in instructions (64 INT32 lanes a clock
# per SM, half its 128 FP32 lanes; an FMA is two flops)
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
IMAD_PER_MONTMUL = 256  # 8-word CIOS: 64 + 64 word products, two IMADs each
IMAD_PER_MONTSQR = 200
IMAD_PER_MADD = 8 * IMAD_PER_MONTMUL + 3 * IMAD_PER_MONTSQR  # mixed add
IMAD_PER_JADD = 12 * IMAD_PER_MONTMUL + 4 * IMAD_PER_MONTSQR  # Jacobian add
ELEM_BYTES = 32
SCALAR_BITS = 256
DEFAULT_C = 13


def window_bits(n: int) -> int:
    """The bucket window c of an MSM over n points."""
    return min(DEFAULT_C, max(4, n.bit_length() - 5))


def bound_s(work: dict) -> float:
    return max(work["bytes"] / HBM_BYTES_PER_S, work["ops"] / IMAD_PER_S)


def _stage_mults(B: int, n: int, s: int) -> int:
    # a butterfly of stage s whose twiddle is 1 needs no multiply
    return B * (n // 2) - B * (n >> (s + 1))


def ntt_work(B: int, k: int) -> dict:
    """A transform of B columns of 2^k, each element read and written once."""
    n = 1 << k
    mults = sum(_stage_mults(B, n, s) for s in range(k))
    return dict(bytes=2 * ELEM_BYTES * B * n + ELEM_BYTES * (n - 1),
                ops=IMAD_PER_MONTMUL * mults)


def msm_work(n: int, batch: int, madds: int) -> dict:
    """`batch` MSMs over n affine points: each point and scalar read once, a
    mixed add per nonzero digit (`madds`), then per window the running sums
    over 2^c buckets (two Jacobian adds a bucket)."""
    c = window_bits(n)
    windows = -(-SCALAR_BITS // c)
    return dict(bytes=2 * ELEM_BYTES * n + ELEM_BYTES * batch * n,
                ops=IMAD_PER_MADD * madds + IMAD_PER_JADD * windows * batch * 2 * (1 << c))


# Montgomery words (R = 2^256) back to the standard form, in 16-bit limbs so
# that every product and carry fits an int64 tensor
_L16 = 16
_R_LIMBS = [(BN_R >> (16 * i)) & 0xFFFF for i in range(_L16)]
_N0INV = (-pow(BN_R, -1, 1 << 16)) % (1 << 16)


def from_mont_limbs(words: torch.Tensor) -> list:
    """(8, ...) int32 Montgomery words -> 16 int64 tensors, the 16-bit limbs
    (low first) of the standard values, by one REDC."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    t = [(u[i // 2] >> (16 * (i % 2))) & 0xFFFF for i in range(_L16)]
    t.append(torch.zeros_like(t[0]))
    for _ in range(_L16):
        m = (t[0] * _N0INV) & 0xFFFF
        carry = (t[0] + m * _R_LIMBS[0]) >> 16
        nt = []
        for j in range(1, _L16):
            s = t[j] + m * _R_LIMBS[j] + carry
            nt.append(s & 0xFFFF)
            carry = s >> 16
        s = t[_L16] + carry
        nt.append(s & 0xFFFF)
        nt.append(s >> 16)
        t = nt
    # t < 2r: subtract r where t >= r
    borrow = torch.zeros_like(t[0])
    d = []
    for j in range(_L16):
        v = t[j] - _R_LIMBS[j] - borrow
        borrow = (v < 0).to(torch.int64)
        d.append(v + (borrow << 16))
    v = t[_L16] - borrow
    keep = v < 0  # t < r
    return [torch.where(keep, t[j], d[j]) for j in range(_L16)]


def nonzero_digits(words: torch.Tensor, n: int) -> int:
    """Nonzero c-bit windows (c = window_bits(n)) of the standard values of
    Montgomery `words`, (8, ...) int32: the mixed adds a bucket MSM of them
    needs at the least."""
    c = window_bits(n)
    limbs = from_mont_limbs(words)
    count = 0
    for w in range(-(-SCALAR_BITS // c)):
        lo, hi = w * c, min(w * c + c, SCALAR_BITS)
        acc = torch.zeros_like(limbs[0])
        for j in range(lo // 16, (hi - 1) // 16 + 1):
            a, b = max(lo, 16 * j), min(hi, 16 * j + 16)
            part = (limbs[j] >> (a - 16 * j)) & ((1 << (b - a)) - 1)
            acc = acc | (part << (a - lo))
        count += int((acc != 0).sum())
    return count
