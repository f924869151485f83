"""The port's int8 tensor-core Montgomery multiply (ops/mxu_mod.py) against
the JAX package's (CPU).

On a CPU tensor `mxu_montmul_rows` takes its plain version, the kernel's
steps in plain PyTorch; csrc/mxu.cu runs only on the card, where
chip_smoke.py holds it against that plain version and the montmul kernel.
The two packages keep Montgomery values with different R (2^256 against
2^264) and the JAX output is lazy, so they are compared as canonical
integers; against the port's own montmul the words must be equal. The
kernel's register chain (the m16n8k32 fragments of one product feeding the
next) is emulated lane by lane in numpy on the kernel's own matrix image.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webauthn_halo2_tpu.fields.limbs import FR_SPEC as J_FR
from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC
from webauthn_halo2_tpu_torch.ops import modops as M
from webauthn_halo2_tpu_torch.ops import mxu_mod as X

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

SPECS = {"fr": FR_SPEC, "fq": FQ_SPEC}


def _ints(seed: int, p: int, n: int) -> list[int]:
    """Random values below p, with the edge values 0, 1, 2, p-2, p-1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    vals[:5] = [0, 1, 2, p - 2, p - 1]
    return vals


@pytest.mark.parametrize("name", sorted(SPECS))
def test_constants_fit_int8_and_invert_the_vandermonde(name):
    spec = SPECS[name]
    cs = X.consts(spec)
    assert cs.ev.dtype == cs.iv.dtype == cs.fold.dtype == np.uint8
    assert cs.ev.shape == X.EVAL_SHAPE and cs.fold.shape == X.FOLD_SHAPE
    assert cs.iv.shape == (2, 2) + X.INTERP_SHAPE  # prime, parity
    # every product coefficient sum_{i+j=t} a_i b_j is below q1 q2
    assert X.NL * 255 ** 2 < X.Q1 * X.Q2
    ev = cs.ev.astype(np.int64)
    t_col = np.array([[X.interp_col(t, f) for f in range(2)] for t in range(X.UP)])
    u_row = np.array([X.interp_row(u, 0) for u in range(X.UP)])
    for P, q in enumerate((X.Q1, X.Q2)):
        # EVAL byte pairs recombine to x^i mod q at x = u and x = -u
        cols = X.EV_COL[P]  # [u, sign, byte]
        val = ev[:, cols[..., 0]] + 256 * ev[:, cols[..., 1]]  # [i, u, sign]
        for i, u in ((3, 5), (31, 31), (0, 0), (7, 1)):
            assert val[i, u, 0] == pow(u, i, q)
            assert u == 0 or val[i, u, 1] == pow(q - u, i, q)
        assert not val[:, 0, 1].any()  # "-0": the zero column
        # INTERP (byte 0 rows, with its 2^32 and, for q2, q1^-1) inverts
        # S_u = w_u sum_i c_2i u^2i (w_0 = 1, else 2) and D_u = 2 sum_i
        # c_2i+1 u^(2i+1): it times that map is the scale times I
        scale = X.R32 * (cs.inv12 if P else 1) % q
        for par, u0, n in ((0, 0, X.UP), (1, 1, X.UP - 1)):
            iv = cs.iv[P, par].astype(np.int64)
            vi = (iv[u_row][:, t_col[:, 0]] + 256 * iv[u_row][:, t_col[:, 1]]) % q  # [u, t]
            fwd = np.array([[(1 if u == 0 and par == 0 else 2) * pow(u, 2 * i + par, q)
                             for i in range(n)] for u in range(u0, u0 + n)], dtype=np.int64)
            assert ((vi[u0:u0 + n, :n].T @ fwd) % q == (np.eye(n, dtype=np.int64) * scale) % q).all()
            assert not vi[:, n:].any() and not vi[:u0].any()
    # FOLD rows: byte e of r1_t carries 2^(8e + 8t) 2^-256 mod p
    rinv = pow(spec.R, -1, spec.p)
    for blk, t, e in ((0, 0, 0), (0, 62, 1), (1, 17, 0), (1, 62, 1)):
        row = cs.fold[X.fold_row(blk, t, e)].astype(object)
        got = sum(int(row[X.fold_col(limb)]) << (8 * limb) for limb in range(X.NL))
        assert got == (X.Q1 if blk else 1) * (1 << (8 * e + 8 * t)) * rinv % spec.p


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_equals_montmul_word_for_word(name):
    spec = SPECS[name]
    a = torch.as_tensor(spec.encode(_ints(1, spec.p, 512)))
    b = torch.as_tensor(spec.encode(_ints(2, spec.p, 512)[::-1]))
    assert torch.equal(X.mxu_montmul_rows(spec, a, b), M.montmul_plain(spec, a, b))
    assert torch.equal(X.mxu_montmul_rows(spec, a, a), M.montmul_plain(spec, a, a))
    # every pair of the edge values, as words and in Montgomery form
    p = spec.p
    edge = [0, 1, 2, p - 2, p - 1]
    for mont in (False, True):
        ea = torch.as_tensor(spec.encode([x for x in edge for _ in edge], mont=mont))
        eb = torch.as_tensor(spec.encode([y for _ in edge for y in edge], mont=mont))
        assert torch.equal(X.mxu_montmul_rows(spec, ea, eb), M.montmul_plain(spec, ea, eb))


def test_plain_matches_jax_mxu_montmul_rows_in_interpret_mode():
    from webauthn_halo2_tpu.ops.mxu_mod import mxu_montmul_rows

    xs, ys = _ints(3, FR_SPEC.p, 256), _ints(4, FR_SPEC.p, 256)
    got = FR_SPEC.decode(X.mxu_montmul_rows(
        FR_SPEC, torch.as_tensor(FR_SPEC.encode(xs)), torch.as_tensor(FR_SPEC.encode(ys))).numpy())
    jout = mxu_montmul_rows(J_FR, jnp.asarray(J_FR.encode(xs).T), jnp.asarray(J_FR.encode(ys).T),
                            block=128)
    want = J_FR.decode(np.asarray(jout).T)
    assert got == want == [x * y % FR_SPEC.p for x, y in zip(xs, ys)]


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    a = torch.as_tensor(FR_SPEC.encode([5, 7]))
    with pytest.raises(ValueError, match="CUDA"):
        X.mxu_montmul_rows_cuda(FR_SPEC, a, a)
    X.mxu_montmul_rows(FR_SPEC, a, a)
    assert X.LAUNCHES == {"mxu_montmul": 0}


# --- the kernel's register chain, lane by lane --------------------------------

LANE = np.arange(32)
G, TT = LANE >> 2, LANE & 3
J4 = np.arange(4)
M32 = 0xFFFFFFFF


def _mma(c, a, b0, b1):
    """c (32, 4) plus one m16n8k32 u8 product of the lanes' registers: a
    (32, 4) uint32 holds A bytes 4t.. (rows g, g + 8) and 16 + 4t.. (rows
    g, g + 8), b0 and b1 (32,) the B column g at depths 4t.. and 16 + 4t..;
    lane (g, t) gets D columns 2t, 2t + 1 of rows g and g + 8."""
    B = np.zeros((32, 8), dtype=np.int64)
    for off, x in ((0, b0), (16, b1)):
        B[off + 4 * TT[:, None] + J4, G[:, None]] = \
            np.ascontiguousarray(x, dtype=np.uint32).view(np.uint8).reshape(32, 4)
    D = _a_matrix(a) @ B
    return c + np.stack([D[G, 2 * TT], D[G, 2 * TT + 1], D[G + 8, 2 * TT],
                         D[G + 8, 2 * TT + 1]], axis=1)


def _prmt(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of y:x."""
    b = np.concatenate([np.ascontiguousarray(v, dtype=np.uint32)[:, None].view(np.uint8)
                        for v in (x, y)], axis=1)
    return np.ascontiguousarray(b[:, [(sel >> (4 * i)) & 7 for i in range(4)]]).view(
        np.uint32)[:, 0]


def _a_matrix(regs):
    """The (16, 32) A tile that the lanes' registers (32, 4) hold."""
    A = np.zeros((16, 32), dtype=np.int64)
    ab = np.ascontiguousarray(regs, dtype=np.uint32).view(np.uint8).reshape(32, 4, 4)
    for r, (dr, off) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        A[(G + dr)[:, None], off + 4 * TT[:, None] + J4] = ab[:, r]
    return A


def _emulate_tile(spec, aw, bw, e0):
    """csrc/mxu.cu on the 16 elements from e0 of (8, M) uint32 operands, one
    m16 tile of a warp: returns the A tiles each product read (INTERP's S
    and D per prime (16, 64), FOLD's (16, 256)), the rows' limb sums (16, 32) from
    the two word parts of each thread, and each row's result as an int."""
    img = X.kernel_image(spec)
    qinv0, qinv1, bar0, bar1, ninv12, q12, tail_m = X.consts(spec).scalars()
    qinv, bar = (qinv0, qinv1), (bar0, bar1)
    n = aw.shape[1]

    def frag(x):
        rows = e0 + G[:, None] + 8 * (J4 & 1)
        words = TT[:, None] + 4 * (J4 >> 1)
        return np.where(rows < n, x[words, np.minimum(rows, n - 1)], 0).astype(np.uint32)

    fa, fb = frag(aw), frag(bw)
    zero = np.zeros((32, 4), dtype=np.int64)
    xa = np.zeros((2, 2, 2, 32, 4), dtype=np.uint32)  # prime, parity, k-step, lane, register
    for P, q in enumerate((X.Q1, X.Q2)):
        for k in range(2):
            sd = [[], []]
            for j in range(4):
                row = img[P * 8 + k * 4 + j]
                cs = []
                for sign in range(2):
                    b0, b1 = row[:, 2 * sign], row[:, 2 * sign + 1]
                    ca, cb = _mma(zero, fa, b0, b1), _mma(zero, fb, b0, b1)
                    ea = ca[:, [0, 2]] + 256 * ca[:, [1, 3]]  # (lane, row g / g + 8)
                    eb = cb[:, [0, 2]] + 256 * cb[:, [1, 3]]
                    ea = (ea & 16383) + (16384 - q) * (ea >> 14)
                    prod = (ea * eb).astype(np.uint64)
                    m = ((prod & M32) * np.uint64(qinv[P])) & M32
                    cs.append(((prod >> 32) + q - ((m * q) >> 32)).astype(np.int64))
                sd[0].append(cs[0] + cs[1])
                sd[1].append(cs[0] - cs[1] + 2 * q)
            for par in range(2):
                for r in range(2):
                    lo = _prmt(sd[par][0][:, r], sd[par][1][:, r], 0x5410)
                    hi = _prmt(sd[par][2][:, r], sd[par][3][:, r], 0x5410)
                    xa[P, par, k, :, r] = _prmt(lo, hi, 0x6420)
                    xa[P, par, k, :, 2 + r] = _prmt(lo, hi, 0x7531)
    fo = [zero] * 4
    fold_a = []
    for k in range(8):
        y = np.zeros((2, 32, 2), dtype=np.uint32)
        for par in range(2):
            f1, f2 = img[16 + (k * 2 + par) * 2], img[16 + (k * 2 + par) * 2 + 1]
            x1, x2 = zero, zero.copy()
            x2[:, [0, 2]] = q12
            for h in range(2):
                x1 = _mma(x1, xa[0, par, h], f1[:, 2 * h], f1[:, 2 * h + 1])
                x2 = _mma(x2, xa[1, par, h], f2[:, 2 * h], f2[:, 2 * h + 1])
            for r in range(2):
                v1 = x1[:, 2 * r] + 256 * x1[:, 2 * r + 1]
                r1 = v1 - X.Q1 * ((v1 * bar[0]) >> 45)
                v2 = (x2[:, 2 * r] + 256 * x2[:, 2 * r + 1] + r1 * ninv12) & M32
                y[par, :, r] = _prmt(r1, v2 - X.Q2 * ((v2 * bar[1]) >> 45), 0x5410)
        fa2 = np.stack([_prmt(y[0, :, r % 2], y[1, :, r % 2], 0x7351 if r >> 1 else 0x6240)
                        for r in range(4)], axis=1)
        fold_a.append(_a_matrix(fa2))
        f0, f1 = img[48 + 2 * k], img[48 + 2 * k + 1]
        fo = [_mma(fo[nn], fa2, f[:, 2 * (nn % 2)], f[:, 2 * (nn % 2) + 1])
              for nn, f in enumerate((f0, f0, f1, f1))]
    limbs = np.zeros((16, 32), dtype=np.int64)
    values = [0] * 16
    for r in range(2):
        for half in range(2):  # X: limbs 8t..8t+3 from n-tiles 0, 1; Y: 8t+4.. from 2, 3
            part = sum(fo[2 * half + lh // 2][:, 2 * r + lh % 2] << (8 * lh) for lh in range(4))
            for lane in range(32):
                row = int(G[lane]) + 8 * r
                values[row] += int(part[lane]) << (64 * int(TT[lane]) + 32 * half)
                for lh in range(4):
                    limbs[row, 8 * TT[lane] + 4 * half + lh] = \
                        fo[2 * half + lh // 2][lane, 2 * r + lh % 2]
    p = spec.p
    outs = []
    for v in values:
        d = v - X.tail_quotient(v, tail_m) * p
        assert 0 <= d < 2 * p
        outs.append(d - p if d >= p else d)
    interp_a = [np.concatenate([_a_matrix(xa[P, par, k]) for k in range(2)], axis=1)
                for P in range(2) for par in range(2)]
    return interp_a, np.concatenate(fold_a, axis=1), limbs, outs


@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_register_chain_emulated(name):
    """Every lane's accumulators, after the pointwise step and the CRT and
    the byte permutes, are the A bytes its next product reads: the packed
    registers equal the plain version's permuted operands, and the kernel's
    result its words, on 2.5 tiles (a ragged last one) with edge values."""
    spec = SPECS[name]
    n = 40
    xs, ys = _ints(5, spec.p, n), _ints(6, spec.p, n)
    xs[5:10] = xs[:5]
    ys[:10] = [0, 1, 2, spec.p - 2, spec.p - 1] * 2
    a, b = torch.as_tensor(spec.encode(xs)), torch.as_tensor(spec.encode(ys))
    steps = X.plain_steps(spec, a, b)
    aw, bw = (t.numpy().view(np.uint32) for t in (a, b))
    want = [v % spec.p for v in spec.decode(steps["out"].numpy(), mont=False)]
    assert want == [v % spec.p for v in spec.decode(M.montmul_plain(spec, a, b).numpy(),
                                                     mont=False)]
    for e0 in range(0, n, 16):
        k = min(16, n - e0)
        interp_a, fold_a, limbs, outs = _emulate_tile(spec, aw, bw, e0)
        for i in range(4):
            assert (interp_a[i][:k] == steps["interp_in"][i][e0:e0 + k].numpy()).all()
        assert (fold_a[:k] == steps["fold_in"][e0:e0 + k].numpy()).all()
        assert (limbs[:k] == steps["limbs"][e0:e0 + k].numpy()).all()
        assert outs[:k] == want[e0:e0 + k]


def test_kernel_image_holds_each_fragment():
    """Row i of the image holds fragments 2i and 2i + 1; lane (g, t) of a
    fragment (n, k) holds column 8n + g of the matrix at depths 32k + 4t..
    and 32k + 16 + 4t.. (spot checks by hand)."""
    cs = X.consts(FR_SPEC)
    img = X.kernel_image(FR_SPEC)
    assert img.shape == (64, 32, 4) and img.dtype == np.uint32

    def word(mat, col, depth):
        return int.from_bytes(bytes(int(v) for v in mat[depth:depth + 4, col]), "little")

    g, t = 5, 3
    lane = 4 * g + t
    # EVAL n-tile 7 (row 3, second half)
    assert img[3, lane, 2] == word(cs.ev, 8 * 7 + g, 4 * t)
    assert img[3, lane, 3] == word(cs.ev, 8 * 7 + g, 16 + 4 * t)
    # INTERP (prime 1, odd, n-tile 5, k-step 1): fragment ((5 * 2 + 1) * 2 + 1) * 2 + 1
    f = 16 * 2 + ((5 * 2 + 1) * 2 + 1) * 2 + 1
    assert img[f // 2, lane, 2 * (f % 2)] == word(cs.iv[1, 1], 8 * 5 + g, 32 + 4 * t)
    # FOLD (k-step 6, n-tile 2): fragment 6 * 4 + 2
    f = 16 * 2 + 64 + 6 * 4 + 2
    assert img[f // 2, lane, 2 * (f % 2) + 1] == word(cs.fold, 8 * 2 + g, 192 + 16 + 4 * t)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tail_quotient_at_extreme_values(name):
    """q' = floor((V >> 238) floor(2^270 / p) / 2^32) is floor(V / p) or one
    less at V = 0, p - 1, p, 2p - 1 and the largest V the fold can give."""
    spec = SPECS[name]
    p = spec.p
    cs = X.consts(spec)
    v_max = 2 * X.T * (255 + ((max(X.Q1, X.Q2) - 1) >> 8)) * (p - 1)
    assert v_max < 1 << 270
    rng = np.random.default_rng(7)
    randoms = [int(Fraction(int(r), 1 << 62) * v_max) for r in rng.integers(0, 1 << 62, 200)]
    for v in [0, p - 1, p, 2 * p - 1, v_max, v_max - p, (v_max // p) * p - 1] + randoms:
        q = X.tail_quotient(v, cs.tail_m)
        assert v // p - q in (0, 1), v
        assert 0 <= v - q * p < 2 * p
