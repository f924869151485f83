"""Word codec + per-modulus constants for the port's device field arithmetic.

Representation (chosen for Hopper, not the TPU):
  A field element is eight little-endian 32-bit words, stored as int32
  (bit-cast from uint32), laid out word-major: shape (8, *batch). Word i of
  neighbouring batch elements is contiguous, so a CUDA thread per element
  reads coalesced. Montgomery R = 2^256.

Every device op returns a value fully reduced into [0, p), so
`normalize` is the identity and a zero test or an equality is a word
compare. Montgomery tensors therefore differ from the JAX package's
33-limb R = 2^264 tensors by design; compare decoded integers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

W = 8  # 32-bit words per element
WBITS = 32


def ints_to_words(xs) -> np.ndarray:
    """Host ints in [0, 2^256) -> (8, n) int32 words (bytes-based, fast)."""
    xs = [int(x) for x in xs]
    b = b"".join(x.to_bytes(4 * W, "little") for x in xs)
    arr = np.frombuffer(b, dtype="<u4").reshape(len(xs), W)
    return arr.T.copy().view(np.int32)


def words_to_ints(a) -> list[int]:
    """(8, n) int32 words (any batch shape flattened) -> host ints."""
    arr = np.asarray(a)
    arr = np.ascontiguousarray(arr.reshape(W, -1).T).view(np.uint32)
    raw = arr.astype("<u4").tobytes()
    n = arr.shape[0]
    return [int.from_bytes(raw[4 * W * i: 4 * W * (i + 1)], "little")
            for i in range(n)]


@dataclass(eq=False)
class FieldSpec:
    """Precomputed constants for one prime modulus (identity hash/eq)."""

    name: str
    p: int
    R: int = 0
    r_mod_p: int = 0
    r2_mod_p: int = 0
    n0: int = 0  # -p^-1 mod 2^32
    p_words: np.ndarray = field(default=None)  # (8,) int32
    one_mont: np.ndarray = field(default=None)  # (8,) words of R mod p

    def __post_init__(self):
        p = self.p
        assert p < 1 << 254, "CIOS without a top carry word needs p < R/4"
        self.R = 1 << (W * WBITS)
        self.r_mod_p = self.R % p
        self.r2_mod_p = self.R * self.R % p
        self.n0 = (-pow(p, -1, 1 << WBITS)) % (1 << WBITS)
        self.p_words = ints_to_words([p])[:, 0]
        self.one_mont = ints_to_words([self.r_mod_p])[:, 0]

    def to_mont_int(self, x: int) -> int:
        return x * self.R % self.p

    def from_mont_int(self, x: int) -> int:
        return x * pow(self.R, -1, self.p) % self.p

    def encode(self, xs, mont: bool = True) -> np.ndarray:
        """Host ints -> (8, n) words (Montgomery form by default)."""
        if mont:
            xs = [self.to_mont_int(int(x) % self.p) for x in xs]
        else:
            xs = [int(x) % self.p for x in xs]
        return ints_to_words(xs)

    def decode(self, a, mont: bool = True) -> list[int]:
        """(8, *batch) words -> canonical host ints (batch flattened)."""
        vals = [v % self.p for v in words_to_ints(a)]
        if mont:
            rinv = pow(self.R, -1, self.p)
            vals = [v * rinv % self.p for v in vals]
        return vals

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


from .constants import BN254_FQ, BN254_FR  # noqa: E402

FQ_SPEC = FieldSpec("bn254_fq", BN254_FQ)
FR_SPEC = FieldSpec("bn254_fr", BN254_FR)
