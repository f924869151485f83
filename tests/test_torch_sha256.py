"""The port's SHA-256 chip (circuits/sha256.py) against hashlib (CPU).

The chip's output cells hold the digest as witness values; they must
equal hashlib.sha256 at the padding edges: the empty message, one short
block, 55 bytes (the longest one-block message), 56 (the first that
needs two), 64 (a full block) and 69 (the ES256 message, 37 bytes of
authenticator data and a 32-byte client-data hash). The messages come
from a seeded generator, so a failure repeats. Synthesis only: the
constraints are checked by the mock at k=17 in tests/test_torch_mock.py.
"""
import hashlib

import numpy as np
import pytest

from webauthn_halo2_tpu_torch.circuits.builder import CircuitBuilder
from webauthn_halo2_tpu_torch.circuits.sha256 import Sha256Chip


def _digest_cells(msg: bytes) -> bytes:
    b = CircuitBuilder(num_advice=4, num_lookup_advice=1, lookup_bits=16)
    sha = Sha256Chip(b)
    cells = b.load_witnesses(list(msg))
    for c in cells:
        b.range_check(c, 8)
    return bytes(c.value for c in sha.sha256(cells, len(msg)))


@pytest.mark.parametrize("length", [0, 3, 55, 56, 64, 69])
def test_sha256_witness_matches_hashlib(length):
    msg = np.random.default_rng(length).bytes(length)
    assert _digest_cells(msg) == hashlib.sha256(msg).digest()
