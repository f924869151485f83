"""Montgomery multiply through int8 matrix products (tensor cores).

The port of the JAX package's ops/mxu_mod.py: `mxu_montmul_rows` and its
Pallas kernel `_pallas_fn` over `_pipeline_rows`. The product a * b of two
field elements is a convolution of their limbs; it is routed through
products with constant matrices by evaluating the limb polynomials at
fixed points modulo two small primes. On the card every contraction is a
u8 x u8 -> int32 tensor-core product in csrc/mxu.cu.

The port's layout, not the TPU's: an operand is the port's (8, M) Montgomery
words, fully reduced, read as 32 byte-limbs a_i in [0, 256); R = 2^256.
The result is a * b * 2^-256 mod p in [0, p): the same words as
`modops.montmul`. Steps, each matrix stored (depth, width) in the order the
kernel's m16n8k32 fragments chain (below):

  1. EVAL   (2M, 32) @ (32, 256): both operands' limb polynomials at the
     63 points 0, +-1, ..., +-31 modulo q1 = 16381 and q2 = 16369. The
     limbs are the unsigned int8 operand as they are; each entry x^i mod q
     is split into two bytes, so one accumulator pair gives E = c0 + 256 c1
     < 2^27 (`eval_col`; the 64th column pair of a prime, "-0", is zero).
  2. POINTWISE  C = E_a' E_b 2^-32 mod q per point and prime, with E_a'
     = (E_a mod 2^14) + (2^14 - q) (E_a >> 14) < 2^17.1 (one shift-fold of
     2^14 = q + d) and a Montgomery step on the 64-bit product:
     C = hi + q - umulhi(lo q^-1, q), in [1, q + 2^13): two bytes.
  3. INTERP per prime, split by parity: S_u = C(u) + C(-u) = w_u Ev(u^2)
     and D_u = C(u) - C(-u) + 2q = 2u Od(u^2) mod q, for the even part Ev and
     the odd part Od of the product polynomial (w_0 = 1, else 2), so two
     (M, 64) @ (64, 64) products, each the inverse of its Vandermonde in
     u^2, give the coefficients c_t mod q, t = 0..62: the even from S_0..31,
     the odd from D_1..31. Their entries are premultiplied by 2^32 (which
     cancels step 2's factor; prime 2's also by q1^-1 mod q2, for the CRT).
     Column 2t + f is byte f of the parity's t-th coefficient.
  4. CRT    r1 = x1 mod q1 and s = (x2' + q1 q2 - r1 (q1^-1 mod q2)) mod q2
     (x2' = r2 q1^-1 mod q2 up to multiples of q2), each by a multiply with
     ceil(2^45/q), exact; then c_t = r1_t + q1 s_t: c_t = sum_{i+j=t} a_i
     b_j < 32 * 255^2 < 2^21, well below q1 q2 (about 2^28).
  5. FOLD   (M, 256) @ (256, 32): the row of (block, t, byte e) carries
     (1 or q1) * 2^(8e) * 2^(8t) * 2^-256 mod p as 32 byte-limbs, so the
     limb sums o_l give V = sum_l o_l 2^(8l), congruent to a b 2^-256 mod p.
  6. TAIL   carries put V < 2^269 into nine words; q' = floor((V >> 238)
     floor(2^270 / p) / 2^32) is floor(V / p) or one less, so V - q' p lies
     in [0, 2p) and one conditional subtraction lands it in [0, p).

The fragment chain (csrc/mxu.cu). In an m16n8k32 product thread (g, t) of a
warp (g = lane / 4, t = lane % 4) holds the C columns 2t and 2t + 1 of each
n8 tile for rows g and g + 8, and reads the A bytes 4t..4t+3 and
16+4t..16+4t+3 of each 32-deep k-step for the same rows. So the two bytes of
a point's E sit in one thread, and so do the two bytes of a coefficient:
EVAL's n-tiles 16P + 8k + 2j and 16P + 8k + 2j + 1 give thread t the points
+u and -u, u = 16k + 4j + t, whose S and D bytes are byte j of its INTERP A
registers at k-step k (`interp_row`); INTERP's even and odd n-tile k give
coefficients 8k + 2t and 8k + 2t + 1, whose r1 and s bytes make up FOLD's A
registers at k-step k (`fold_row`); FOLD's columns are ordered so thread t
ends with limbs 8t..8t+7 (`fold_col`). No value goes through shared memory
between the products.

`consts` asserts every bound the steps rely on. A multiply takes 40,072
int8 multiply-adds (32 x 252 for each operand's evaluation, 64 x 64 and
62 x 62 interpolations for each prime, 252 x 32 for the fold) and
`GLUE_OPS` 32-bit operations around them that any int8 route needs, and
`DESIGN_OPS` more that this kernel's design adds; the CIOS multiply of
csrc/montmul.cu takes 256 32-bit multiply-adds.

Nothing in the prover calls this (as in the JAX package, where only a
benchmark and its tests reach the kernel). `mxu_montmul_rows` launches the
kernel on CUDA tensors and takes `mxu_montmul_rows_plain`, the same steps
with the same matrices in plain PyTorch, on CPU tensors; it counts its
launches in `LAUNCHES`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..device import cached
from ..fields.limbs import W, FieldSpec
from . import kernels as K

Q1, Q2 = 16381, 16369  # 2^14 - 3, 2^14 - 15: primes, product about 2^28
NL = 4 * W  # 32 byte-limbs an operand
T = 2 * NL - 1  # 63 product coefficients and evaluation points
TP = 64  # T padded to a multiple of the tiles
R32 = 1 << 32  # Montgomery radix of the pointwise product
BARRETT_SHIFT = 13  # x mod q = x - q (umulhi(x, ceil(2^45 / q)) >> 13)
TAIL_SHIFT = 238  # q' from V >> 238 < 2^32
# (depth, width) of the three contractions, padded to the m16n8k32 tiles
EVAL_SHAPE = (NL, 2 * 2 * TP)  # (32, 256)
INTERP_SHAPE = (TP, TP)  # (64, 64) per prime and parity
FOLD_SHAPE = (2 * 2 * TP, NL)  # (256, 32)
INT8_MACS = 2 * NL * 2 * 2 * T + 2 * ((T + 1) ** 2 + (T - 1) ** 2) + 2 * 2 * T * NL
# The least 32-bit work around the products, a multiply, that any route of
# int8 products to these words does, step by step as the plain version does
# it (each a single instruction on the card: a multiply-add, a high
# multiply, a funnel shift): the recombines, a modular pointwise product,
# the CRT, the carries and the tail. It is the glue term of the bound.
GLUE_OPS = {
    "eval_recombine": 2 * 2 * T,  # E = c0 + 256 c1, both operands and primes
    "pointwise": 4 * 2 * T,  # 64-bit product, m, umulhi(m, q), hi + q - that
    "interp_recombine": 2 * T,  # x1 and x2'
    "crt": 7 * T,  # r1 (3), x2' - r1 inv (1), s (3)
    "tail_limbs": 3 * W,  # four limb sums to a 64-bit word part: 3 wide multiply-adds
    "tail_carries": 2 * W,  # eight 64-bit adds
    "tail_quotient": 2,  # funnel shift, high multiply
    "tail_subtract": 4 * W + 1,  # q' p: low and high halves, their sum, the subtraction
    "tail_reduce": 2 * W + 1,  # V - q' p - p and the select
}
# What this kernel's own design adds to that, outside the bound: the fold
# of E_a that the Montgomery step with R = 2^32 needs, the even and odd
# sums of the split INTERP, and the byte permutes of the register chain.
DESIGN_OPS = {
    "eval_fold": 3 * 2 * T,  # E_a': an and, a shift, a multiply-add
    "pair_sums": 2 * 2 * (T + 1) // 2,  # S and D for 32 pairs, both primes
    "interp_pack": 2 * (T + 1),  # 128 S and D values to bytes: 4 byte permutes for 4
    "fold_pack": 2 * T,  # r1 | s << 16, then 2 permutes for 2 coefficients
}
GLUE_OPS_TOTAL = sum(GLUE_OPS.values())
DESIGN_OPS_TOTAL = sum(DESIGN_OPS.values())

LAUNCHES = {"mxu_montmul": 0}


# --- where each value sits (the fragment chain above) -----------------------

def eval_col(P: int, u: int, sign: int, e: int) -> int:
    """EVAL column of byte e of prime P's entries at the point u (sign 0)
    or -u (sign 1; for u = 0 a zero column): n-tile 16P + 8k + 2j + sign,
    where u = 16k + 4j + t and thread t holds the column pair."""
    k, j, t = u // 16, (u // 4) % 4, u % 4
    return P * 2 * TP + 8 * (8 * k + 2 * j + sign) + 2 * t + e


def interp_row(u: int, e: int) -> int:
    """INTERP depth row of byte e of S_u (or D_u): k-step u // 16, the
    thread u % 4, byte (u // 4) % 4 of its register for byte e."""
    return 32 * (u // 16) + 16 * e + 4 * (u % 4) + (u // 4) % 4


def interp_col(t: int, f: int) -> int:
    """INTERP column of byte f of the parity's coefficient t."""
    return 2 * t + f


def fold_row(blk: int, c: int, e: int) -> int:
    """FOLD depth row of byte e of r1_c (blk 0) or s_c (blk 1): coefficient
    c = 2 (4k + t) + parity comes from INTERP's n-tile k of that parity in
    thread t, byte 2 blk + parity of its register at k-step k."""
    return 32 * (c // 8) + 16 * e + 4 * ((c // 2) % 4) + 2 * blk + c % 2


def fold_col(limb: int) -> int:
    """FOLD column of byte-limb `limb`: thread limb // 8 holds limbs
    8t..8t+7, limbs 8t + 2n + h in column h of its pair in n-tile n."""
    return 8 * ((limb % 8) // 2) + 2 * (limb // 8) + limb % 2


# rows of the plain version's natural orders that each kernel row reads
UP = TP // 2  # 32 values u of S and D: the points 0, +-1, ..., +-31
IV_SRC = np.empty(2 * UP, dtype=np.int64)  # INTERP row -> 2u + e
FOLD_SRC = np.empty(2 * 2 * TP, dtype=np.int64)  # FOLD row -> blk*128 + 2c + e
for _e in range(2):
    for _u in range(UP):
        IV_SRC[interp_row(_u, _e)] = 2 * _u + _e
    for _c in range(TP):
        for _b in range(2):
            FOLD_SRC[fold_row(_b, _c, _e)] = _b * 2 * TP + 2 * _c + _e
EV_COL = np.array([[[[eval_col(P, u, sg, e) for e in range(2)] for sg in range(2)]
                    for u in range(UP)] for P in range(2)], dtype=np.int64)  # [P, u, sign, e]
FOLD_COL = np.array([fold_col(limb) for limb in range(NL)], dtype=np.int64)
assert sorted(EV_COL.ravel()) == list(range(4 * TP))
assert sorted(IV_SRC) == list(range(2 * UP)) and sorted(FOLD_SRC) == list(range(4 * TP))
assert sorted(FOLD_COL) == list(range(NL))


def _bytes(v: int, n: int) -> list[int]:
    out = [(v >> (8 * i)) & 255 for i in range(n)]
    assert v >> (8 * n) == 0
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
    ev: np.ndarray  # (32, 256) uint8
    iv: np.ndarray  # (2, 2, 64, 64) uint8: prime, parity
    fold: np.ndarray  # (256, 32) uint8
    qinv: tuple  # q^-1 mod 2^32 per prime
    barrett: tuple  # ceil(2^45 / q) per prime
    inv12: int  # q1^-1 mod q2
    tail_m: int  # floor(2^270 / p)

    def scalars(self) -> list[int]:
        """The kernel's scalars, in the order of its MxuScalars."""
        return [*self.qinv, *self.barrett, (-self.inv12) % R32, Q1 * Q2, self.tail_m]


def tail_quotient(v: int, tail_m: int) -> int:
    """The tail's estimate of floor(v / p): floor((v >> 238) m / 2^32)."""
    return ((v >> TAIL_SHIFT) * tail_m) >> 32


@functools.lru_cache(maxsize=None)
def consts(spec: FieldSpec) -> MxuConsts:
    """The constant matrices and scalars for one modulus, with the bounds
    that make every step exact asserted."""
    p = spec.p
    assert NL * 255 ** 2 < Q1 * Q2  # every product coefficient, so the CRT recovers it
    assert Q1 < 1 << 14 and Q2 < 1 << 14

    ev = np.zeros(EVAL_SHAPE, dtype=np.int64)
    for P, q in enumerate((Q1, Q2)):
        for u in range(UP):
            for sign in range(2 if u else 1):
                x = (q - u) % q if sign else u
                for i in range(NL):
                    for e, byte in enumerate(_bytes(pow(x, i, q), 2)):  # pow(0, 0) == 1
                        ev[i, EV_COL[P, u, sign, e]] = byte

    # S_u = C(u) + C(-u) = w_u Ev(u^2), D_u = C(u) - C(-u) = 2u Od(u^2), with
    # Ev(y) = sum_i c_2i y^i, Od(y) = sum_i c_2i+1 y^i, w_0 = 1 (C(-0) is the
    # zero column's C = q) and w_u = 2: the even coefficients from S_0..S_31
    # and the odd ones from D_1..D_31, each by the inverse of its Vandermonde
    inv12 = pow(Q1, -1, Q2)
    ivs = []
    for P, q in enumerate((Q1, Q2)):
        scale = R32 * (inv12 if P else 1) % q
        even = _matinv_mod([[(1 if u == 0 else 2) * pow(u, 2 * i, q) for i in range(UP)]
                            for u in range(UP)], q)  # [t][u]
        odd = _matinv_mod([[2 * pow(u, 2 * i + 1, q) for i in range(UP - 1)]
                           for u in range(1, UP)], q)  # [t][u - 1]
        iv = np.zeros((2,) + INTERP_SHAPE, dtype=np.int64)
        for par, VI, u0 in ((0, even, 0), (1, odd, 1)):
            for t, row in enumerate(VI):
                for u, w in enumerate(row, start=u0):
                    for e in range(2):
                        v = (w << (8 * e)) * scale % q
                        for f, byte in enumerate(_bytes(v, 2)):
                            iv[par, interp_row(u, e), interp_col(t, f)] = byte
        ivs.append(iv)

    rinv = pow(spec.R, -1, p)
    fold = np.zeros(FOLD_SHAPE, dtype=np.int64)
    for blk, scale in enumerate((1, Q1)):
        for e in range(2):
            for t in range(T):
                v = scale * (1 << (8 * e + 8 * t)) * rinv % p
                for limb, byte in enumerate(_bytes(v, NL)):
                    fold[fold_row(blk, t, e), fold_col(limb)] = byte

    qinv = tuple(pow(q, -1, R32) for q in (Q1, Q2))
    barrett = tuple(-(-(1 << (32 + BARRETT_SHIFT)) // q) for q in (Q1, Q2))
    tail_m = (1 << (TAIL_SHIFT + 32)) // p

    # 1. E = sum_i a_i (x^i mod q) < 2^27; the int32 accumulators of every
    #    product (bytes times bytes, prime 2's INTERP starting at q1 q2)
    e_max = NL * 255 * (max(Q1, Q2) - 1)
    assert e_max < 1 << 27
    for depth, start in ((EVAL_SHAPE[0], 0), (INTERP_SHAPE[0], Q1 * Q2), (FOLD_SHAPE[0], 0)):
        assert depth * 255 * 255 + start < 1 << 31
    # 2. E_a' = (E_a mod 2^14) + d (E_a >> 14), d = 2^14 - q; the 64-bit
    #    product E_a' E_b, so hi and C = hi + q - umulhi(m, q) < q + hi
    c_max = 0
    for q, qi in zip((Q1, Q2), qinv):
        assert q * qi % R32 == 1
        ea_max = (1 << 14) - 1 + ((1 << 14) - q) * (e_max >> 14)
        c_max = max(c_max, q + ((ea_max * e_max) >> 32))
    assert c_max < 1 << 15
    # 3-4. S = C(u) + C(-u) and D = C(u) - C(-u) + 2q in [0, 2^16); the
    #    INTERP sums and x2' + q1 q2 - r1 inv12 stay below 2^31, where the
    #    2^45 reciprocal is exact (x (m q - 2^45) < 2^45)
    sd_max = max(2 * c_max, c_max + 2 * max(Q1, Q2))
    assert sd_max < 1 << 16 and c_max < 2 * min(Q1, Q2)
    x_max = UP * (255 + (sd_max >> 8)) * (max(Q1, Q2) - 1) + Q1 * Q2
    assert x_max < 1 << 31 and (Q1 - 1) * (Q2 - 1) < Q1 * Q2
    for q, mb in zip((Q1, Q2), barrett):
        assert mb < R32 and x_max * (mb * q - (1 << (32 + BARRETT_SHIFT))) < 1 << (32 + BARRETT_SHIFT)
    # 5. limb sums below 2^24, V below 2^270 (word 8 below 2^14)
    byte_max = [255, (max(Q1, Q2) - 1) >> 8]  # r1 < q1 and s < q2: bytes 0 and 1
    assert 2 * T * sum(byte_max) * 255 < 1 << 24
    v_max = 2 * T * sum(byte_max) * (p - 1)
    assert v_max < 1 << 270
    # 6. q' is floor(V / p) or one less: V / p - q' < 2^238 / p + (V >> 238) / 2^32 < 1,
    #    never more than floor(V / p) (tail_m <= 2^270 / p)
    assert tail_m < R32
    assert Fraction(1 << TAIL_SHIFT, p) + Fraction(v_max >> TAIL_SHIFT, R32) < 1
    for mat in (ev, *ivs, fold):
        assert mat.min() >= 0 and mat.max() <= 255
    return MxuConsts(
        ev=ev.astype(np.uint8), iv=np.stack(ivs).astype(np.uint8), fold=fold.astype(np.uint8),
        qinv=qinv, barrett=barrett, inv12=inv12, tail_m=tail_m)


# --- the kernel's image of the matrices ---------------------------------------

def _fragment(mat: np.ndarray, n: int, k: int) -> np.ndarray:
    """The m16n8k32 B fragment of n-tile n, k-step k of a (depth, width)
    uint8 matrix: lane (g, t) holds column 8n + g at depths 32k + 4t..
    (b0) and 32k + 16 + 4t.. (b1), little-endian. Returns (32, 2) uint32."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    col = mat[:, 8 * n + g].T  # (32 lanes, depth)
    pair = [col[lane[:, None], 32 * k + off + 4 * t[:, None] + np.arange(4)] for off in (0, 16)]
    return np.ascontiguousarray(np.stack(pair, axis=1)).view(np.uint32)[..., 0]


EV_TILES = [(n, 0) for n in range(EVAL_SHAPE[1] // 8)]
IV_TILES = [(P, par, n, k) for n in range(8) for par in range(2) for P in range(2)
            for k in range(2)]
FOLD_TILES = [(n, k) for k in range(FOLD_SHAPE[0] // 32) for n in range(NL // 8)]


@functools.lru_cache(maxsize=None)
def kernel_image(spec: FieldSpec) -> np.ndarray:
    """The three matrices as the kernel reads them, (64, 32, 4) uint32: row
    i holds fragments 2i and 2i + 1 (b0, b1, b0, b1 a lane: one 16-byte
    load), in the order EVAL's 32 n-tiles (+u and -u share a row),
    INTERP's (n-tile, parity, prime, k-step), FOLD's (k-step, n-tile)."""
    cs = consts(spec)
    frags = np.stack([_fragment(cs.ev, n, k) for n, k in EV_TILES]
                     + [_fragment(cs.iv[P, par], n, k) for P, par, n, k in IV_TILES]
                     + [_fragment(cs.fold, n, k) for n, k in FOLD_TILES])
    return np.ascontiguousarray(frags.reshape(-1, 2, 32, 2).transpose(0, 2, 1, 3)).reshape(-1, 32, 4)


# --- plain version ---------------------------------------------------------

_M32 = 0xFFFFFFFF


def _byte_limbs(a: torch.Tensor) -> torch.Tensor:
    """(8, M) int32 words -> (M, 32) int64 byte-limbs, little-endian."""
    u = a.to(torch.int64) & _M32
    shifts = torch.arange(0, 32, 8, device=a.device)
    return ((u[:, None, :] >> shifts[None, :, None]) & 255).reshape(NL, -1).T


def _two_bytes(x: torch.Tensor) -> torch.Tensor:
    """(..., k) values below 2^16 -> (..., 2k) bytes, byte e of x_j at 2j + e."""
    return torch.stack([x & 255, x >> 8], dim=-1).flatten(-2)


def _dot(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Exact integer product: every partial sum is below 2^31 < 2^53."""
    return torch.matmul(x.to(torch.float64), mat.to(torch.float64)).to(torch.int64)


def _mul_lo32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x c mod 2^32 for x < 2^32 and a 32-bit c, without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _barrett(x: torch.Tensor, q: int, m: int) -> torch.Tensor:
    return x - q * ((x * m) >> (32 + BARRETT_SHIFT))


def plain_steps(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The kernel's steps in plain PyTorch, returning the A operands each
    product reads (`interp_in`: S and D for each prime, (M, 64) each;
    `fold_in` (M, 256); in the kernel's row order), the FOLD sums by limb
    (`limbs`, (M, 32)) and the result (`out`, (8, M) words)."""
    cs = consts(spec)
    dev = a.device
    M_ = a.shape[1]

    def mat(name, arr):
        return cached(("mxu", name, id(spec)), lambda: arr.astype(np.int64), dev, torch.int64)

    ev, iv, fold = mat("ev", cs.ev), mat("iv", cs.iv), mat("fold", cs.fold)
    iv_src = cached(("mxu", "iv_src"), lambda: IV_SRC, dev, torch.int64)
    fold_src = cached(("mxu", "fold_src"), lambda: FOLD_SRC, dev, torch.int64)
    fold_col = cached(("mxu", "fold_col"), lambda: FOLD_COL, dev, torch.int64)
    # columns (prime, k, j, sign, t, byte): point +-u, u = 16k + 4j + t
    E = _dot(torch.cat([_byte_limbs(a), _byte_limbs(b)]), ev).view(2 * M_, 2, 2, 4, 2, 4, 2)
    E = (E[..., 0] + 256 * E[..., 1]).transpose(3, 4)  # (2M, P, k, sign, j, t) below 2^27
    interp_in, x = [], []
    for P, q in enumerate((Q1, Q2)):
        ea, eb = E[:M_, P], E[M_:, P]
        ea = (ea & 16383) + (16384 - q) * (ea >> 14)  # < 2^17.1
        prod = ea * eb  # < 2^44.1
        m = _mul_lo32(prod & _M32, cs.qinv[P])
        C = (prod >> 32) + q - ((m * q) >> 32)  # a b 2^-32 mod q, in [1, q + 2^13)
        cp, cm = C[:, :, 0].reshape(M_, UP), C[:, :, 1].reshape(M_, UP)  # at +u and -u
        parts = []
        for par, V in enumerate((cp + cm, cp - cm + 2 * q)):  # S, D
            interp_in.append(_two_bytes(V)[:, iv_src])
            y = _dot(interp_in[-1], iv[P, par]).view(M_, UP, 2)
            parts.append(y[..., 0] + 256 * y[..., 1])
        x.append(torch.stack(parts, dim=-1).view(M_, TP))  # coefficient 2t + parity
    r1 = _barrett(x[0], Q1, cs.barrett[0])
    s = _barrett(x[1] + Q1 * Q2 - r1 * cs.inv12, Q2, cs.barrett[1])
    fold_in = torch.cat([_two_bytes(r1), _two_bytes(s)], dim=1)[:, fold_src]
    o = _dot(fold_in, fold)[:, fold_col].view(M_, W, 4)  # limb sums < 2^24
    # nine words of V = sum_l o_l 2^(8l)
    acc = o[..., 0] + (o[..., 1] << 8) + (o[..., 2] << 16) + (o[..., 3] << 24)
    words, c = [], 0
    for w in range(W):
        v = acc[:, w] + c
        words.append(v & _M32)
        c = v >> 32
    words.append(c)
    qh = (((words[8] << 18) | (words[7] >> 14)) * cs.tail_m) >> 32
    pw = [int(v) & _M32 for v in spec.p_words] + [0]
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
    out = ((out ^ 0x80000000) - 0x80000000).to(torch.int32)
    return dict(interp_in=interp_in, fold_in=fold_in, limbs=o.view(M_, NL), out=out)


def mxu_montmul_rows_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p for (8, M) word tensors, by the kernel's steps in
    plain PyTorch on any device."""
    return plain_steps(spec, a, b)["out"]


# --- the kernel --------------------------------------------------------------

def mxu_montmul_rows_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """csrc/mxu.cu on CUDA tensors: (8, M) words in, (8, M) words out."""
    dev = K.card_of("the int8 montmul kernel", a, b)
    for t in (a, b):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != W:
            raise TypeError("the int8 montmul kernel takes (8, M) int32 tensors")
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    M_ = a.shape[1]
    out = torch.empty_like(a)
    if M_ == 0:
        return out
    image = cached(("mxu_image", id(spec)), lambda: kernel_image(spec).view(np.int32),
                   dev, torch.int32)
    scalars = (K._U32 * 7)(*consts(spec).scalars())
    with K.on_card(dev) as stream:
        rc = K.lib("mxu").wh2_mxu_montmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M_, image.data_ptr(),
            K.modulus_words(spec), scalars, stream)
    K.check(rc, "int8 montmul kernel")
    LAUNCHES["mxu_montmul"] += 1
    return out


def mma_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k32 u8 tensor-core product on the card, through the kernel's
    own instruction and the fragment maps that `_fragments` and the kernel's
    register chain assume: a (16, 32) times b (8, 32) transposed -> (16, 8)
    int32. A check of the fragment layouts against a host product; no path
    runs it."""
    dev = K.card_of("mma_tile", a, b)
    if a.shape != (16, 32) or b.shape != (8, 32) or a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("mma_tile takes uint8 tensors of (16, 32) and (8, 32)")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((16, 8), dtype=torch.int32, device=dev)
    with K.on_card(dev) as stream:
        rc = K.lib("mxu").wh2_mma_tile(a.data_ptr(), b.data_ptr(), out.data_ptr(), stream)
    K.check(rc, "mma tile kernel")
    return out


def mxu_montmul_rows(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p, the words of `modops.montmul`: the kernel on the
    card, the plain version on the CPU (by where the tensors lie)."""
    if a.device.type == "cpu":
        return mxu_montmul_rows_plain(spec, a, b)
    return mxu_montmul_rows_cuda(spec, a, b)
