"""Montgomery multiply through int8 matrix products (tensor cores).

The port of the JAX package's ops/mxu_mod.py: `mxu_montmul_rows` and its
Pallas kernel `_pallas_fn` over `_pipeline_rows`. The product a * b of two
field elements is a convolution of their limbs; it is routed through
products with constant matrices by evaluating the limb polynomials at
fixed points modulo two small primes. On the card every contraction is an
int8 x int8 -> int32 tensor-core product in csrc/mxu.cu.

The port's layout, not the TPU's: an operand is the port's (8, M) Montgomery
words, fully reduced, read as 32 byte-limbs a_i in [0, 256); R = 2^256.
The result is a * b * 2^-256 mod p in [0, p): the same words as
`modops.montmul`. Steps:

  1. EVAL   (2M, 64) @ (64, 256): both operands' limb polynomials at the
     63 points u = 0..62 modulo q1 = 16381 and q2 = 16369. A byte limb is
     split into 7-bit digit planes (a & 127, a >> 7) to stay int8-exact,
     and each matrix entry 2^(7d) u^i mod q into two balanced base-256
     digits in [-128, 127]; column P*128 + 2u + e holds digit e of prime P
     at point u, so one accumulator pair gives E = c0 + 256 c1.
  2. POINTWISE  C = E_a E_b 2^-16 mod q per point and prime (Montgomery
     with R = 2^16).
  3. INTERP per prime (M, 128) @ (128, 128): the inverse Vandermonde mod q,
     premultiplied by 2^16 (which cancels step 2's factor), gives the
     product polynomial's coefficients c_t mod q, t = 0..62. Rows
     e*64 + u are digit plane e of C_u; column 2t + f is balanced digit f.
  4. CRT    s = (r2 - r1) q1^-1 mod q2, so c_t = r1_t + q1 s_t exactly:
     c_t = sum_{i+j=t} a_i b_j < 32 * 255^2 < 2^21, well below q1 q2
     (about 2^28), so both primes of the JAX package still serve.
  5. FOLD   (M, 256) @ (256, 64): row blk*128 + e*64 + t carries
     (1 or q1) * 2^(7e) * 2^(8t) * 2^-256 mod p as 32 byte-limbs, each
     split into two 4-bit nibbles (column 2l + h), so the sum is congruent
     to a b 2^-256 mod p.
  6. TAIL   carries put the 32 limb sums (each below 2^23) into nine words,
     V < 252 * 127 * p < 2^269; q' = floor((V >> 206) / ((p >> 206) + 1))
     is floor(V / p) or one less, so V - q' p lies in [0, 2p) and one
     conditional subtraction lands it in [0, p).

`consts` asserts every bound the steps rely on. A multiply takes 80,136
int8 multiply-adds (64 x 252 for each operand's evaluation, two
126 x 126 interpolations, 252 x 64 for the fold), 81,920 with the padding
of the kernel's tiles; the CIOS multiply of csrc/montmul.cu takes 256
32-bit multiply-adds.

Nothing in the prover calls this (as in the JAX package, where only a
benchmark and its tests reach the kernel). `mxu_montmul_rows` launches the
kernel on CUDA tensors and takes `mxu_montmul_rows_plain`, the same steps
in plain PyTorch, on CPU tensors; it counts its launches in `LAUNCHES`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import cached
from ..fields.limbs import W, FieldSpec
from . import kernels as K

Q1, Q2 = 16381, 16369  # 2^14 - 3, 2^14 - 15: primes, product about 2^28
NL = 4 * W  # 32 byte-limbs an operand
T = 2 * NL - 1  # 63 product coefficients and evaluation points
TP = 64  # T padded to a multiple of the tiles
R16 = 1 << 16  # Montgomery radix of the pointwise product
TAIL_SHIFT = 206  # V >> 206 < 2^63 for V < 2^269
# (depth, width) of the three contractions, padded to the m16n8k32 tiles
EVAL_SHAPE = (2 * NL, 2 * 2 * TP)  # (64, 256)
INTERP_SHAPE = (2 * TP, 2 * TP)  # (128, 128) per prime
FOLD_SHAPE = (2 * 2 * TP, 2 * NL)  # (256, 64)
INT8_MACS = 2 * 2 * NL * 2 * 2 * T + 2 * (2 * T) ** 2 + 2 * 2 * T * 2 * NL

LAUNCHES = {"mxu_montmul": 0}


def _balanced_digits(v: int, n: int) -> list[int]:
    """v >= 0 -> n balanced base-256 digits in [-128, 127]."""
    out = []
    for _ in range(n):
        d = ((v + 128) & 255) - 128
        out.append(d)
        v = (v - d) >> 8
    assert v == 0
    return out


def _matinv_mod(A, q: int):
    """Inverse of an integer matrix (list of rows) mod a prime q (Gauss)."""
    n = len(A)
    M = [[int(A[i][j]) % q for j in range(n)] + [1 if j == i else 0
         for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if M[r][col] % q)
        M[col], M[piv] = M[piv], M[col]
        inv = pow(M[col][col], -1, q)
        M[col] = [v * inv % q for v in M[col]]
        for r in range(n):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(vr - f * vc) % q for vr, vc in zip(M[r], M[col])]
    return [row[n:] for row in M]


@dataclass(frozen=True)
class MxuConsts:
    ev: np.ndarray  # (64, 256) int8
    iv: np.ndarray  # (2, 128, 128) int8, one per prime
    fold: np.ndarray  # (256, 64) int8
    qinv: tuple  # -q^-1 mod 2^16 per prime
    inv12: int  # q1^-1 mod q2
    pt1: int  # (p >> TAIL_SHIFT) + 1


@functools.lru_cache(maxsize=None)
def consts(spec: FieldSpec) -> MxuConsts:
    """The constant matrices and scalars for one modulus, with the bounds
    that make every step exact asserted."""
    p = spec.p
    # every product coefficient is below q1 q2, so the CRT recovers it
    assert NL * 255 ** 2 < Q1 * Q2
    assert Q1 < 1 << 14 and Q2 < 1 << 14

    ev = np.zeros(EVAL_SHAPE, dtype=np.int64)
    for P, q in enumerate((Q1, Q2)):
        for d in range(2):
            for i in range(NL):
                for u in range(T):
                    v = (pow(u, i, q) << (7 * d)) % q  # pow(0, 0) == 1
                    for e, dig in enumerate(_balanced_digits(v, 2)):
                        ev[d * NL + i, P * 2 * TP + 2 * u + e] = dig

    ivs = []
    for q in (Q1, Q2):
        # c_t = sum_u VI[t][u] E_u, VI the inverse of A[u][i] = u^i mod q
        VI = _matinv_mod([[pow(u, i, q) for i in range(T)] for u in range(T)], q)
        iv = np.zeros(INTERP_SHAPE, dtype=np.int64)
        for e in range(2):
            for u in range(T):
                for t in range(T):
                    v = (VI[t][u] << (7 * e)) * R16 % q
                    for f, dig in enumerate(_balanced_digits(v, 2)):
                        iv[e * TP + u, 2 * t + f] = dig
        ivs.append(iv)

    rinv = pow(spec.R, -1, p)
    fold = np.zeros(FOLD_SHAPE, dtype=np.int64)
    for blk, scale in enumerate((1, Q1)):
        for e in range(2):
            for t in range(T):
                v = scale * (1 << (7 * e + 8 * t)) * rinv % p
                for limb in range(NL):
                    byte = (v >> (8 * limb)) & 255
                    fold[blk * 2 * TP + e * TP + t, 2 * limb] = byte & 15
                    fold[blk * 2 * TP + e * TP + t, 2 * limb + 1] = byte >> 4
    for mat in (ev, *ivs):
        assert mat.min() >= -128 and mat.max() <= 127
    assert fold.min() >= 0 and fold.max() <= 15
    # int32 accumulators: |digit plane| <= 127 against |entry| <= 128; the
    # recombined E and interpolation sums (exact residue sums) below 2^31
    for depth in (EVAL_SHAPE[0], INTERP_SHAPE[0], FOLD_SHAPE[0]):
        assert depth * 127 * 128 < 1 << 31
    assert EVAL_SHAPE[0] * 127 * max(Q1, Q2) < 1 << 31
    assert INTERP_SHAPE[0] * 127 * max(Q1, Q2) < 1 << 31
    # the fold's limb sums o_l = N_2l + 16 N_2l+1 stay below 2^23, and the
    # value below 2^269, so V >> 206 fits an int64
    assert 17 * FOLD_SHAPE[0] * 127 * 15 < 1 << 23
    assert 2 * 2 * T * 127 * p < 1 << (TAIL_SHIFT + 63)
    # floor(V / p) - q' <= 1 needs (p >> 206)^2 well above V >> 206
    pt = p >> TAIL_SHIFT
    assert pt * pt > 1 << 64
    return MxuConsts(
        ev=ev.astype(np.int8), iv=np.stack(ivs).astype(np.int8),
        fold=fold.astype(np.int8),
        qinv=tuple((-pow(q, -1, R16)) % R16 for q in (Q1, Q2)),
        inv12=pow(Q1, -1, Q2), pt1=pt + 1)


# --- plain version ---------------------------------------------------------

_M32 = 0xFFFFFFFF


def _byte_limbs(a: torch.Tensor) -> torch.Tensor:
    """(8, M) int32 words -> (M, 32) int64 byte-limbs, little-endian."""
    u = a.to(torch.int64) & _M32
    shifts = torch.arange(0, 32, 8, device=a.device)
    return ((u[:, None, :] >> shifts[None, :, None]) & 255).reshape(NL, -1).T


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(M, k) values below 2^14 -> (M, 2k) 7-bit digit planes [x & 127, x >> 7]."""
    return torch.cat([x & 127, x >> 7], dim=1)


def _dot(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Exact integer product: every partial sum is below 2^31 < 2^53."""
    return torch.matmul(x.to(torch.float64), mat.to(torch.float64)).to(torch.int64)


def _pointwise(ea, eb, q, qinv):
    prod = ea * eb  # < 2^28
    m = ((prod & 0xFFFF) * qinv) & 0xFFFF
    t = (prod + m * q) >> 16  # < 2q
    return torch.where(t >= q, t - q, t)


def mxu_montmul_rows_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p for (8, M) word tensors, by the kernel's steps in
    plain PyTorch on any device."""
    cs = consts(spec)
    dev = a.device
    M_ = a.shape[1]

    def mat(name, arr):
        return cached(("mxu", name, id(spec)), lambda: arr, dev, torch.int64)

    ev, iv, fold = mat("ev", cs.ev), mat("iv", cs.iv), mat("fold", cs.fold)
    qs = torch.tensor([Q1, Q2], device=dev).view(1, 2, 1)
    A8 = _planes(torch.cat([_byte_limbs(a), _byte_limbs(b)]))  # (2M, 64)
    E = _dot(A8, ev).view(2 * M_, 2, TP, 2)
    E = (E[..., 0] + 256 * E[..., 1]) % qs  # (2M, 2, 64): primes, points
    C = [_pointwise(E[:M_, P], E[M_:, P], q, cs.qinv[P])
         for P, q in enumerate((Q1, Q2))]
    r = []
    for P, q in enumerate((Q1, Q2)):
        x = _dot(_planes(C[P]), iv[P]).view(M_, TP, 2)
        r.append((x[..., 0] + 256 * x[..., 1]) % q)  # c_t mod q, (M, 64)
    s = ((r[1] - r[0] + 2 * Q2) * cs.inv12) % Q2
    N = _dot(torch.cat([_planes(r[0]), _planes(s)], dim=1), fold).view(M_, NL, 2)
    o = (N[..., 0] + 16 * N[..., 1]).view(M_, W, 4)  # limb sums < 2^23
    # nine words of V = sum_l o_l 2^(8l)
    acc = o[..., 0] + (o[..., 1] << 8) + (o[..., 2] << 16) + (o[..., 3] << 24)
    words, c = [], 0
    for w in range(W):
        v = acc[:, w] + c
        words.append(v & _M32)
        c = v >> 32
    words.append(c)
    qh = ((words[8] << 50) | (words[7] << 18) | (words[6] >> 14)) // cs.pt1
    pw = [int(x) & _M32 for x in spec.p_words] + [0]
    mc, br, d = 0, 0, []
    for w in range(W + 1):
        pm = qh * pw[w] + mc
        mc = pm >> 32
        v = words[w] - (pm & _M32) - br
        br = (v < 0).to(torch.int64)
        d.append(v & _M32)
    # V - q' p in [0, 2p): one conditional subtraction of p
    e, br = [], 0
    for w in range(W):
        v = d[w] - pw[w] - br
        br = (v < 0).to(torch.int64)
        e.append(v & _M32)
    out = torch.where((br != 0)[None], torch.stack(d[:W]), torch.stack(e))
    return ((out ^ 0x80000000) - 0x80000000).to(torch.int32)


# --- the kernel --------------------------------------------------------------

def mxu_montmul_rows_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """csrc/mxu.cu on CUDA tensors: (8, M) words in, (8, M) words out."""
    for t in (a, b):
        if t.device.type != "cuda":
            raise ValueError(f"the int8 montmul kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != W:
            raise TypeError("the int8 montmul kernel takes (8, M) int32 tensors")
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    M_ = a.shape[1]
    out = torch.empty_like(a)
    if M_ == 0:
        return out
    cs = consts(spec)
    dev = a.device

    def mat(name, arr):  # the kernel takes each matrix as (width, depth)
        return cached(("mxu_t", name, id(spec)),
                      lambda: np.ascontiguousarray(np.swapaxes(arr, -1, -2)),
                      dev, torch.int8)

    rc = K.lib("mxu").wh2_mxu_montmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M_,
        mat("ev", cs.ev).data_ptr(), mat("iv", cs.iv).data_ptr(),
        mat("fold", cs.fold).data_ptr(), K.modulus_words(spec),
        cs.qinv[0], cs.qinv[1], cs.inv12, cs.pt1, K.stream_ptr(dev))
    K.check(rc, "int8 montmul kernel")
    LAUNCHES["mxu_montmul"] += 1
    return out


def mma_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k32 int8 tensor-core product on the card, through the
    kernel's own fragment loads: a (16, 32) times b (8, 32) transposed ->
    (16, 8) int32. A check of the fragment layouts against a host product;
    no path runs it."""
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError("mma_tile needs CUDA tensors")
    if a.shape != (16, 32) or b.shape != (8, 32) or a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("mma_tile takes int8 tensors of (16, 32) and (8, 32)")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((16, 8), dtype=torch.int32, device=a.device)
    K.check(K.lib("mxu").wh2_mma_tile(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                      K.stream_ptr(a.device)), "mma tile kernel")
    return out


def mxu_montmul_rows(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p, the words of `modops.montmul`: the kernel on the
    card, the plain version on the CPU (by where the tensors lie)."""
    if a.device.type == "cpu":
        return mxu_montmul_rows_plain(spec, a, b)
    return mxu_montmul_rows_cuda(spec, a, b)
