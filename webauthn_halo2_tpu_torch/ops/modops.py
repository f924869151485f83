"""Modular arithmetic over word tensors (the port's device field core).

Every function takes int32 tensors of shape (8, *batch) holding eight
32-bit words per element (fields/limbs.py), with values in [0, p), and
returns values in [0, p). Arguments broadcast against each other over the
batch axes, as the JAX package's do.

`montmul` is the one kernel here: on a CUDA tensor it launches the
hand-written kernel (csrc/montmul.cu) at any size; on a CPU tensor it runs
`montmul_plain`, the same multiply in plain PyTorch. Add, subtract and the
rest are plain PyTorch ops on either device: 64-bit lanes hold the 32-bit
words while carries and borrows ripple through them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import cached
from ..fields.limbs import W, FieldSpec, ints_to_words
from . import kernels as K

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF

LAUNCHES = {"montmul": 0}


def _const_np(key, spec: FieldSpec, arr: np.ndarray, device, dtype) -> torch.Tensor:
    return cached((key, id(spec)), lambda: np.asarray(arr), device, dtype)


def _bc(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(8,) constant -> (8, 1, ...) broadcastable against ndim dims."""
    return t.reshape((t.shape[0],) + (1,) * (ndim - 1))


def const(spec: FieldSpec, value: int, device, mont: bool = True) -> torch.Tensor:
    """(8, 1) tensor of one field constant, kept on the device (the
    constants of a circuit and its arguments are a bounded set)."""
    return _const_np(("c", value, mont), spec,
                     spec.encode([value], mont=mont), device, torch.int32)


def const_like(spec: FieldSpec, value: int, a: torch.Tensor) -> torch.Tensor:
    """A field constant shaped (8, 1, ..., 1) to broadcast against a."""
    return _bc(const(spec, value, a.device), a.ndim)


def _u64(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int64) & _M32


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 with the same bits."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def _p64(spec: FieldSpec, device, ndim: int) -> torch.Tensor:
    p = _const_np("p64", spec, spec.p_words.view(np.uint32).astype(np.int64),
                  device, torch.int64)
    return _bc(p, ndim)


def _ripple_carry(s: torch.Tensor) -> torch.Tensor:
    """(8, ...) int64 word sums (each < 2^63) -> exact words in [0, 2^32);
    the caller guarantees the value fits in 256 bits."""
    words = list(s.unbind(0))
    c = None
    for i in range(W):
        v = words[i] if c is None else words[i] + c
        words[i] = v & _M32
        c = v >> 32
    return torch.stack(words)


def _ripple_sub(a: torch.Tensor, b: torch.Tensor):
    """Unsigned words a - b (int64, broadcastable) -> (words mod 2^256,
    borrow-out mask)."""
    d = list((a - b).unbind(0))
    neg = None
    for i in range(W):
        v = d[i] if neg is None else d[i] + neg
        d[i] = v & _M32
        neg = v >> 32  # -1 on borrow, else 0
    return torch.stack(d), neg != 0


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = _ripple_carry(_u64(a) + _u64(b))  # < 2p < 2^255
    d, borrow = _ripple_sub(s, _p64(spec, s.device, s.ndim))
    return _to_i32(torch.where(borrow[None], s, d))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _ripple_sub(_u64(a), _u64(b))
    e = _ripple_carry(d + _p64(spec, d.device, d.ndim))  # drops the 2^256
    return _to_i32(torch.where(borrow[None], e, d))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def _halves(a: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 words -> (16, ...) int64 16-bit limbs."""
    u = _u64(a)
    return torch.stack([u & _M16, u >> 16], dim=1).reshape((2 * W,) + u.shape[1:])


def montmul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p in plain PyTorch, on any device.

    CIOS in int64 lanes: each of the eight steps multiplies one 32-bit word
    of a (and one 32-bit Montgomery digit m) into b and p held as sixteen
    16-bit limbs, so a limb gains less than 2^49 per step and never nears
    2^63. The result is below 2p before the final conditional subtract."""
    a, b = torch.broadcast_tensors(a, b)
    A = _u64(a)
    Bh = _halves(b)
    nd = Bh.ndim
    p16 = _bc(_const_np("p16", spec, np.array(
        [(spec.p >> (16 * i)) & _M16 for i in range(2 * W)], dtype=np.int64),
        a.device, torch.int64), nd)
    n0_lo, n0_hi = spec.n0 & _M16, spec.n0 >> 16
    # step i works on rows [2i, 2i + 16) of t, so the shift by one word is
    # an offset instead of a copy; the result lands in rows [16, 32)
    t = torch.zeros((4 * W + 1,) + Bh.shape[1:], dtype=torch.int64,
                    device=a.device)
    for i in range(W):
        r = 2 * i
        win = t[r:r + 2 * W]
        win.addcmul_(Bh, A[i])
        # m = (t mod 2^32) * n0 mod 2^32, kept below 2^63 throughout
        x = ((t[r] & _M32) + ((t[r + 1] & _M16) << 16)) & _M32
        m = (x * n0_lo + (((x * n0_hi) & _M16) << 16)) & _M32
        win.addcmul_(p16, m)
        # t[r] + t[r + 1] * 2^16 is now a multiple of 2^32: carry it up
        t[r + 2] += ((t[r] >> 16) + t[r + 1]) >> 16
    # exact carry across the 16-bit limbs, then pack into 32-bit words
    limbs = list(t[2 * W:4 * W].unbind(0))
    c = None
    for i in range(2 * W):
        v = limbs[i] if c is None else limbs[i] + c
        limbs[i] = v & _M16
        c = v >> 16
    words = torch.stack([limbs[2 * i] | (limbs[2 * i + 1] << 16)
                         for i in range(W)])
    d, borrow = _ripple_sub(words, _p64(spec, a.device, nd))
    return _to_i32(torch.where(borrow[None], words, d))


def _kernel_operand(x: torch.Tensor, batch_shape) -> tuple[torch.Tensor, int, int]:
    """(tensor, limb stride, broadcast flag) for the montmul kernel: one
    element broadcasts; a batch part that is dense and in order keeps its
    limb stride; anything else is copied."""
    if x.numel() == W:
        return x, x.stride(0), 1
    x = x.expand((W,) + tuple(batch_shape))
    expect = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size == 1:
            continue
        if stride != expect:
            return x.contiguous(), x.numel() // W, 0
        expect *= size
    return x, x.stride(0), 0


def montmul_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/montmul.cu on CUDA tensors (broadcasting like torch)."""
    dev = K.card_of("montmul_cuda", a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("montmul takes int32 word tensors")
    if a.shape[0] != W or b.shape[0] != W:
        raise ValueError(f"montmul takes (8, *batch) tensors, got {tuple(a.shape)}, {tuple(b.shape)}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    batch = shape[1:]
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = out.numel() // W
    if n == 0:
        return out
    a_, a_ls, a_bc = _kernel_operand(a, batch)
    b_, b_ls, b_bc = _kernel_operand(b, batch)
    with K.on_card(dev) as stream:
        rc = K.lib("montmul").wh2_montmul(
            a_.data_ptr(), a_ls, a_bc, b_.data_ptr(), b_ls, b_bc, out.data_ptr(),
            n, K.modulus_words(spec), spec.n0, stream)
    K.check(rc, "montmul kernel")
    LAUNCHES["montmul"] += 1
    return out


def montmul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p: the CUDA kernel on the card, the plain version on
    the CPU (decided by where the tensors lie, never by a fallback)."""
    if a.device.type == "cpu":
        return montmul_plain(spec, a, b)
    return montmul_cuda(spec, a, b)


def montsquare(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return montmul(spec, a, a)


def mul_const(spec: FieldSpec, a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small non-negative integer constant."""
    assert 0 <= c < 1 << 12
    return montmul(spec, a, const_like(spec, c, a))


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    r2 = _const_np("r2", spec, ints_to_words([spec.r2_mod_p])[:, 0],
                   a.device, torch.int32)
    return montmul(spec, a, _bc(r2, a.ndim))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    one = _const_np("one_std", spec, ints_to_words([1])[:, 0], a.device,
                    torch.int32)
    return montmul(spec, a, _bc(one, a.ndim))


def one_mont(spec: FieldSpec, device, ndim: int = 2) -> torch.Tensor:
    return _bc(_const_np("one_mont", spec, spec.one_mont, device, torch.int32),
               ndim)


def normalize(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical residue: every port value already is one."""
    return a


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field select: cond has the batch shape."""
    return torch.where(cond[None], a, b)


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host exponent; Montgomery in, Montgomery out."""
    if e == 0:
        return one_mont(spec, a.device, a.ndim).expand(a.shape).contiguous()
    result, base = None, a
    while True:
        if e & 1:
            result = base if result is None else montmul(spec, result, base)
        e >>= 1
        if not e:
            return result
        base = montsquare(spec, base)


def inv_fermat(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """mont(x) -> mont(x^-1) via x^(p-2); zero maps to zero."""
    return pow_const(spec, a, spec.p - 2)


def prefix_mul(spec: FieldSpec, a: torch.Tensor, axis: int = 1,
               reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) product along `axis` by Hillis-Steele
    log passes, as the JAX package computes it."""
    n = a.shape[axis]
    one = one_mont(spec, a.device, a.ndim)
    off = 1
    while off < n:
        pad_shape = list(a.shape)
        pad_shape[axis] = off
        ones_blk = one.expand(pad_shape)
        if not reverse:
            shifted = torch.cat([ones_blk, a.narrow(axis, 0, n - off)], dim=axis)
        else:
            shifted = torch.cat([a.narrow(axis, off, n - off), ones_blk], dim=axis)
        a = montmul(spec, a, shifted)
        off *= 2
    return a


def _host_inverse(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """mont(x) -> mont(x^-1) for a few elements, on the host: one copy each
    way instead of the ~380 dependent multiplies of `inv_fermat`. Zero maps
    to zero."""
    vals = spec.decode(a.cpu().numpy())
    inv = [pow(v, -1, spec.p) if v else 0 for v in vals]
    return torch.as_tensor(spec.encode(inv).reshape(a.shape)).to(a.device)


def batch_inverse(spec: FieldSpec, a: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Montgomery batch inversion along `axis`: two prefix-product passes
    and one inverse of the total. Zeros map to zero."""
    n = a.shape[axis]
    one = one_mont(spec, a.device, a.ndim).expand(a.shape)
    zero_mask = is_zero(spec, a)
    safe = torch.where(zero_mask[None], one, a)
    prefix = prefix_mul(spec, safe, axis)
    suffix = prefix_mul(spec, safe, axis, True)
    total = prefix.narrow(axis, n - 1, 1)
    total_inv = _host_inverse(spec, total)
    pad_shape = list(a.shape)
    pad_shape[axis] = 1
    ones1 = one_mont(spec, a.device, a.ndim).expand(pad_shape)
    shift_fwd = torch.cat([ones1, prefix.narrow(axis, 0, n - 1)], dim=axis)
    shift_bwd = torch.cat([suffix.narrow(axis, 1, n - 1), ones1], dim=axis)
    inv = montmul(spec, montmul(spec, shift_fwd, shift_bwd), total_inv)
    return torch.where(zero_mask[None], torch.zeros_like(inv), inv)
