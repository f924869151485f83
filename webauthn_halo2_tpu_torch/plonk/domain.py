"""Evaluation domain: subgroup H (size 2^k) + extended coset (size 2^ek).

Polynomials live in three bases: Lagrange on H (assignment form),
coefficients, and evaluations on the extended coset g * H_ext (for the
quotient). Basis changes are NTTs; the coset generator is the Fr
multiplicative generator 7. Tensors are (8, n) or stacks (8, B, n).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.constants import BN254_FR, BN254_FR_GENERATOR
from ..fields.limbs import FR_SPEC
from ..ops import ntt as N

R = BN254_FR
COSET_GEN = BN254_FR_GENERATOR


@dataclass(frozen=True)
class Domain:
    k: int
    extended_k: int

    def __hash__(self):
        return hash((self.k, self.extended_k))

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def ext_n(self) -> int:
        return 1 << self.extended_k

    @property
    def omega(self) -> int:
        return N.root_of_unity(self.k)

    @property
    def omega_ext(self) -> int:
        return N.root_of_unity(self.extended_k)

    def lagrange_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        return N.intt(FR_SPEC, a, self.k)

    def coeff_to_extended(self, a: torch.Tensor) -> torch.Tensor:
        """coeff (8, [B,] n) -> evaluations on the coset g*H_ext."""
        pad = torch.zeros(a.shape[:-1] + (self.ext_n - a.shape[-1],),
                          dtype=a.dtype, device=a.device)
        a = torch.cat([a, pad], dim=-1)
        return N.ntt(FR_SPEC, N.coset_shift(FR_SPEC, a, COSET_GEN),
                     self.extended_k)

    def extended_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        """coset evals (8, [B,] ext_n) -> coeffs (caller truncates)."""
        coeffs = N.intt(FR_SPEC, a, self.extended_k)
        return N.coset_shift(FR_SPEC, coeffs, pow(COSET_GEN, R - 2, R))

    @functools.lru_cache(maxsize=None)
    def zh_inv_extended_np(self) -> np.ndarray:
        """(8, ext_n) Montgomery words of 1 / Z_H(coset point j): periodic
        with period ext_n / n, never zero on the coset."""
        period = self.ext_n // self.n
        gn = pow(COSET_GEN, self.n, R)
        wn = pow(self.omega_ext, self.n, R)
        vals = []
        acc = gn
        for _ in range(period):
            vals.append(pow((acc - 1) % R, R - 2, R))
            acc = acc * wn % R
        tiled = FR_SPEC.encode(vals)
        return np.tile(tiled, (1, self.ext_n // period))
