"""Device polynomial utilities: power tables, point evaluation, sums."""
from __future__ import annotations

import torch

from ..fields.limbs import FieldSpec
from . import modops as M


def mod_sum(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Field sum along the last axis -> (8, ..., 1), by halving passes."""
    while a.shape[-1] > 1:
        n = a.shape[-1]
        if n % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
            n += 1
        a = M.add(spec, a[..., :n // 2], a[..., n // 2:])
    return a


def power_table(spec: FieldSpec, x_mont: torch.Tensor, n: int) -> torch.Tensor:
    """(8, 1) Montgomery x -> (8, n) [1, x, x^2, ..., x^(n-1)] (log passes)."""
    one = M.one_mont(spec, x_mont.device)
    seq = torch.cat([one, x_mont.expand(x_mont.shape[0], n - 1)], dim=1)
    return M.prefix_mul(spec, seq, 1)


def eval_at(spec: FieldSpec, coeffs: torch.Tensor, xpow: torch.Tensor) -> torch.Tensor:
    """Evaluate coefficient-form polynomials at the point whose power
    table is xpow."""
    nc = coeffs.shape[-1]
    return mod_sum(spec, M.montmul(spec, coeffs, xpow[..., :nc]))


def inner_product(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mod_sum(spec, M.montmul(spec, a, b))
