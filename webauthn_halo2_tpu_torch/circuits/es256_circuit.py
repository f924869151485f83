"""ES256 / WebAuthn circuit: in-circuit SHA-256 + ECDSA-P256 verification.

Completes what the reference left unfinished (es256.rs:1 "TODO: Fix SHA",
module disabled at ecc/mod.rs:2 — SURVEY §2.1): proves

    msghash = SHA-256( authenticatorData || clientDataHash )
    ECDSA-P256-Verify(pk, msghash, (r, s))

with authenticatorData (37 bytes, the standard rpIdHash||flags||counter
layout — index.tsx:67-131) and clientDataHash (32 bytes) as private
witnesses alongside r, s, pk. This is exactly the browser-side message
construction (msghash = SHA256(authData || SHA256(clientDataJSON)),
index.tsx:186-197) moved into the circuit.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields.ref_curve import P256_CURVE, ecdsa_sign
from .builder import CircuitBuilder
from .ecdsa import EcdsaChip
from .bigint import CrtInt
from .ecdsa_circuit import CircuitParams
from .sha256 import Sha256Chip

AUTH_DATA_LEN = 37  # rpIdHash(32) + flags(1) + signCount(4)
MSG_LEN = AUTH_DATA_LEN + 32


@dataclass
class ES256Inputs:
    r: int
    s: int
    authenticator_data: bytes  # 37 bytes
    client_data_hash: bytes  # 32 bytes
    pk: tuple[int, int]

    @property
    def msghash(self) -> int:
        return int.from_bytes(
            hashlib.sha256(
                self.authenticator_data + self.client_data_hash
            ).digest(),
            "big",
        )

    @staticmethod
    def dummy() -> "ES256Inputs":
        import random

        rng = random.Random(0xE5256)
        auth = bytes(rng.randrange(256) for _ in range(AUTH_DATA_LEN))
        cdh = bytes(rng.randrange(256) for _ in range(32))
        m = int.from_bytes(hashlib.sha256(auth + cdh).digest(), "big")
        sk = 1 + rng.randrange(P256_CURVE.n - 1)
        pk = P256_CURVE.mul(sk, P256_CURVE.g)
        k = 1 + rng.randrange(P256_CURVE.n - 1)
        r, s = ecdsa_sign(m, sk, k=k)
        return ES256Inputs(r, s, auth, cdh, pk)


class ES256Circuit:
    """Full WebAuthn ES256 statement (BASELINE config 2/3)."""

    def __init__(self, params: CircuitParams | None = None):
        # the SHA rounds add ~170k cells over the plain ECDSA circuit
        self.params = params or CircuitParams(num_advice=9, num_lookup_advice=2)

    def build(self, inputs: ES256Inputs | None = None, check: bool = True):
        inputs = inputs or ES256Inputs.dummy()
        p = self.params
        b = CircuitBuilder(
            num_advice=p.num_advice,
            num_lookup_advice=p.num_lookup_advice,
            lookup_bits=p.lookup_bits,
            check=check,
        )
        sha = Sha256Chip(b)
        ecdsa = EcdsaChip(b)

        msg = inputs.authenticator_data + inputs.client_data_hash
        assert len(msg) == MSG_LEN
        msg_cells = b.load_witnesses(list(msg))
        for c in msg_cells:
            b.range_check(c, 8)
        digest = sha.sha256(msg_cells, MSG_LEN)  # 32 BE byte cells

        # m = BE-int(digest) as an 88x3-limb CrtInt (value < 2^256; the
        # ECDSA gadget reduces mod n inside u1 = m * s^-1)
        m_int = inputs.msghash
        le = list(reversed(digest))  # little-endian byte cells
        limbs = []
        for j, width in enumerate((11, 11, 10)):
            grp = le[11 * j : 11 * j + width]
            limbs.append(
                b.inner_product(grp, [1 << (8 * i) for i in range(len(grp))])
            )
        m = CrtInt(limbs, m_int)

        ecdsa.verify_with_m(inputs.r, inputs.s, m, inputs.pk)
        return b.finalize(p.degree)

    def stats(self) -> dict:
        b = CircuitBuilder(
            num_advice=self.params.num_advice,
            num_lookup_advice=self.params.num_lookup_advice,
            lookup_bits=self.params.lookup_bits,
        )
        sha = Sha256Chip(b)
        ecdsa = EcdsaChip(b)
        i = ES256Inputs.dummy()
        msg = i.authenticator_data + i.client_data_hash
        cells = b.load_witnesses(list(msg))
        for c in cells:
            b.range_check(c, 8)
        digest = sha.sha256(cells, MSG_LEN)
        le = list(reversed(digest))
        limbs = [
            b.inner_product(le[11 * j : 11 * j + w],
                            [1 << (8 * k) for k in range(w)])
            for j, w in enumerate((11, 11, 10))
        ]
        ecdsa.verify_with_m(i.r, i.s, CrtInt(limbs, i.msghash), i.pk)
        return {
            "gate_cells": [len(c) for c in b.columns],
            "total_gate_cells": sum(len(c) for c in b.columns),
            "lookup_cells": len(b.lookup_values),
            "pair_lookups": {k: len(v["pairs"]) for k, v in b.pair_tables.items()},
            "constants": len(b.const_col),
            "copies": len(b.copies),
        }
