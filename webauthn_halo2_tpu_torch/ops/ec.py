"""Jacobian elliptic-curve arithmetic over word tensors (bn254 G1).

Coordinates are (8, *batch) int32 Montgomery words over Fq; Z == 0 encodes
the point at infinity. Every field value is fully reduced, so Z is zero
exactly when all its words are.

`add` is complete (P == Q, P == -Q and infinities resolved by selects);
`add_unsafe` handles infinities only, for sums of disjoint subsets of
distinct base points (Pippenger accumulation).

`add_unsafe_fast` is the one kernel here: on CUDA tensors it launches the
fused add of csrc/ec.cu (the JAX package's `ec_add_unsafe_pallas`, which it
takes when WH2_PALLAS=1), on CPU tensors `add_unsafe`, its plain version,
word for word. It counts its launches in `LAUNCHES`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..fields.constants import BN254_B
from ..fields.limbs import FQ_SPEC, W, FieldSpec
from . import kernels as K
from . import modops as M

LAUNCHES = {"ec_add_unsafe": 0}


class JPoint(NamedTuple):
    x: torch.Tensor  # (8, *batch)
    y: torch.Tensor
    z: torch.Tensor


@dataclass(frozen=True)
class CurveSpec:
    field: FieldSpec
    a: int  # short Weierstrass a (0 for bn254)
    b: int

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


BN254_CURVE = CurveSpec(FQ_SPEC, 0, BN254_B)


def infinity(batch_shape=(), curve: CurveSpec = BN254_CURVE,
             device="cpu") -> JPoint:
    shape = (W,) + tuple(batch_shape)
    one = M.one_mont(curve.field, device, len(shape)).expand(shape)
    return JPoint(one, one, torch.zeros(shape, dtype=torch.int32, device=device))


def from_affine_ints(curve: CurveSpec, pts: list, device="cpu") -> JPoint:
    """Host affine int points (None = infinity) -> Jacobian words (8, n)."""
    f = curve.field
    xs = [p[0] if p else 0 for p in pts]
    ys = [p[1] if p else 1 for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return JPoint(*(torch.as_tensor(f.encode(v)).to(device) for v in (xs, ys, zs)))


def to_affine_ints(curve: CurveSpec, pt: JPoint) -> list:
    """Jacobian point(s) -> host affine ints (batch flattened)."""
    f = curve.field
    xs, ys, zs = (f.decode(c.cpu().numpy()) for c in pt)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, f.p)
            out.append((x * zi * zi % f.p, y * zi ** 3 % f.p))
    return out


def point_select(cond: torch.Tensor, a: JPoint, b: JPoint) -> JPoint:
    return JPoint(M.select(cond, a.x, b.x), M.select(cond, a.y, b.y),
                  M.select(cond, a.z, b.z))


def double(curve: CurveSpec, p: JPoint) -> JPoint:
    """Jacobian doubling; correct for Z = 0 (stays at infinity) and y = 0."""
    f = curve.field
    X, Y, Z = p
    A = M.montsquare(f, X)
    Bv = M.montsquare(f, Y)
    C = M.montsquare(f, Bv)
    t = M.montsquare(f, M.add(f, X, Bv))
    D = M.mul_const(f, M.sub(f, M.sub(f, t, A), C), 2)
    E = M.mul_const(f, A, 3)
    if curve.a != 0:
        z4 = M.montsquare(f, M.montsquare(f, Z))
        E = M.add(f, E, M.montmul(f, M.const_like(f, curve.a, X), z4))
    F = M.montsquare(f, E)
    X3 = M.sub(f, F, M.mul_const(f, D, 2))
    Y3 = M.sub(f, M.montmul(f, E, M.sub(f, D, X3)), M.mul_const(f, C, 8))
    Z3 = M.montmul(f, M.mul_const(f, Y, 2), Z)
    return JPoint(X3, Y3, Z3)


def _add_core(f: FieldSpec, p: JPoint, q: JPoint):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = M.montsquare(f, Z1)
    Z2Z2 = M.montsquare(f, Z2)
    U1 = M.montmul(f, X1, Z2Z2)
    U2 = M.montmul(f, X2, Z1Z1)
    S1 = M.montmul(f, Y1, M.montmul(f, Z2, Z2Z2))
    S2 = M.montmul(f, Y2, M.montmul(f, Z1, Z1Z1))
    H = M.sub(f, U2, U1)
    Rv = M.sub(f, S2, S1)
    HH = M.montsquare(f, H)
    HHH = M.montmul(f, H, HH)
    V = M.montmul(f, U1, HH)
    RR = M.montsquare(f, Rv)
    X3 = M.sub(f, M.sub(f, RR, HHH), M.mul_const(f, V, 2))
    Y3 = M.sub(f, M.montmul(f, Rv, M.sub(f, V, X3)), M.montmul(f, S1, HHH))
    Z3 = M.montmul(f, M.montmul(f, Z1, Z2), H)
    return JPoint(X3, Y3, Z3), H, Rv


def add(curve: CurveSpec, p: JPoint, q: JPoint) -> JPoint:
    """Complete Jacobian addition (handles P == Q, P == -Q, infinities)."""
    f = curve.field
    z1_zero = M.is_zero(f, p.z)
    z2_zero = M.is_zero(f, q.z)
    added, H, Rv = _add_core(f, p, q)
    h_zero = M.is_zero(f, H)
    r_zero = M.is_zero(f, Rv)
    both = ~z1_zero & ~z2_zero
    same = h_zero & r_zero & both
    opposite = h_zero & ~r_zero & both
    out = point_select(same, double(curve, p), added)
    inf = infinity(p.x.shape[1:], curve, p.x.device)
    out = point_select(opposite, inf, out)
    out = point_select(z1_zero, q, out)
    return point_select(z2_zero, p, out)


def add_unsafe(curve: CurveSpec, p: JPoint, q: JPoint) -> JPoint:
    """Jacobian add handling infinities only, NOT the P == +-Q cases."""
    f = curve.field
    out, _, _ = _add_core(f, p, q)
    out = point_select(M.is_zero(f, p.z), q, out)
    return point_select(M.is_zero(f, q.z), p, out)


def add_unsafe_cuda(curve: CurveSpec, p: JPoint, q: JPoint) -> JPoint:
    """The fused add of csrc/ec.cu on CUDA tensors: the six coordinates
    broadcast to one (8, *batch) shape, which the kernel walks flattened."""
    coords = (*p, *q)
    dev = K.card_of("the fused EC add", *coords)
    for t in coords:
        if t.dtype != torch.int32 or t.shape[0] != W:
            raise TypeError("the fused EC add takes (8, *batch) int32 tensors")
    shape = torch.broadcast_shapes(*(t.shape for t in coords))
    ins = [t.expand(shape).contiguous() for t in coords]
    out = JPoint(*(torch.empty(shape, dtype=torch.int32, device=dev)
                   for _ in range(3)))
    n = out.x.numel() // W
    if n == 0:
        return out
    f = curve.field
    with K.on_card(dev) as stream:
        rc = K.lib("ec").wh2_ec_add_unsafe(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in out), n,
            K.modulus_words(f), f.n0, stream)
    K.check(rc, "fused EC add kernel")
    LAUNCHES["ec_add_unsafe"] += 1
    return out


def add_unsafe_fast(curve: CurveSpec, p: JPoint, q: JPoint) -> JPoint:
    """`add_unsafe` in one kernel on the card; `add_unsafe` itself on the
    CPU (decided by where the tensors lie, never by a fallback)."""
    if p.x.device.type == "cpu":
        return add_unsafe(curve, p, q)
    return add_unsafe_cuda(curve, p, q)


def is_on_curve(curve: CurveSpec, p: JPoint) -> torch.Tensor:
    """y^2 == x^3 + a x z^4 + b z^6 (projective check); infinity passes."""
    f = curve.field
    X, Y, Z = p
    y2 = M.montsquare(f, Y)
    x3 = M.montmul(f, M.montsquare(f, X), X)
    z2 = M.montsquare(f, Z)
    z4 = M.montsquare(f, z2)
    z6 = M.montmul(f, z4, z2)
    rhs = M.add(f, x3, M.montmul(f, M.const_like(f, curve.b, X), z6))
    if curve.a != 0:
        rhs = M.add(f, rhs, M.montmul(
            f, M.montmul(f, M.const_like(f, curve.a, X), X), z4))
    return M.is_zero(f, M.sub(f, y2, rhs)) | M.is_zero(f, Z)
