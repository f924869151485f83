"""The ECDSA-P256 circuit: reference `ECDSACircuit<Fr>` equivalent.

Mirrors the reference's interface (ecdsa_p256.rs:53-72): private witnesses
r, s, msghash in Fq(secp256r1), pk on Secp256r1, NO public instances
(instances = [] everywhere, ecdsa_p256.rs:245/373); circuit shape driven by
the same CircuitParams vocabulary as `src/configs/ecdsa_circuit.config`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

from ..fields.ref_curve import P256_CURVE, ecdsa_keygen, ecdsa_sign
from .builder import CircuitBuilder
from .ecdsa import EcdsaChip


@dataclass
class CircuitParams:
    """Same fields as the reference JSON config (ecdsa_circuit.config)."""

    strategy: str = "Simple"
    degree: int = 17
    num_advice: int = 7
    num_lookup_advice: int = 1
    num_fixed: int = 1
    lookup_bits: int = 16
    limb_bits: int = 88
    num_limbs: int = 3
    # balance gate regions across columns by load (needed for the
    # high-column low-k bench shapes; default off keeps the production
    # layout stable)
    balance_columns: bool = False
    # expose the msghash limbs as public inputs (instance column): binds
    # the proof to its message ON CHAIN — the reference's open TODO
    # (P256Account.sol:77). Default off = reference parity (zero
    # instances, ecdsa_p256.rs:245/373).
    expose_msghash: bool = False

    @staticmethod
    def from_json(s: str) -> "CircuitParams":
        d = json.loads(s)
        return CircuitParams(**{k: d[k] for k in d})

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


@dataclass
class ECDSAInputs:
    r: int
    s: int
    msghash: int
    pk: tuple[int, int]

    @staticmethod
    def dummy() -> "ECDSAInputs":
        """Deterministic valid signature for keygen/layout (the reference
        uses Value::unknown(); our layout is witness-independent, so any
        satisfiable witness works)."""
        import random

        rng = random.Random(0xECD5A)
        sk = 1 + rng.randrange(P256_CURVE.n - 1)
        pk = P256_CURVE.mul(sk, P256_CURVE.g)
        m = rng.randrange(P256_CURVE.n)
        k = 1 + rng.randrange(P256_CURVE.n - 1)
        r, s = ecdsa_sign(m, sk, k=k)
        return ECDSAInputs(r, s, m, pk)


def auto_params(degree: int) -> CircuitParams:
    """Column counts for a given degree (the reference's k-vs-columns
    tradeoff, bench_ecdsa.config / SURVEY §2.3): count the circuit's cells
    once, then size advice/lookup columns to fit 2^degree rows."""
    lb = min(16, degree - 1)
    probe = CircuitParams(degree=degree, num_advice=1, num_lookup_advice=1,
                          lookup_bits=lb)
    b = CircuitBuilder(num_advice=8, num_lookup_advice=1, lookup_bits=lb)
    chip = EcdsaChip(b)
    i = ECDSAInputs.dummy()
    chip.verify(i.r, i.s, i.msghash, i.pk)
    total = sum(len(c) for c in b.columns)
    lookups = len(b.lookup_values)
    n = 1 << degree
    usable = n - 16  # conservative blinding margin
    table_rows = 1 << lb
    room = usable - 0
    assert room > table_rows, f"degree {degree} too small for lookup table"
    na = -(-total // (usable - 64))
    nl = -(-lookups // (usable - 64))
    probe.num_advice = max(1, na)
    probe.num_lookup_advice = max(1, nl)
    # high-column shapes need load-balanced region placement (one skewed
    # column otherwise exceeds the usable rows regardless of column count)
    probe.balance_columns = degree <= 14
    return probe


class ECDSACircuit:
    def __init__(self, params: CircuitParams | None = None):
        self.params = params or CircuitParams()
        assert self.params.limb_bits == 88 and self.params.num_limbs == 3, (
            "this build specializes the CRT chip to 88x3 limbs "
            "(the reference's production configuration)"
        )

    def build(self, inputs: ECDSAInputs | None = None, check: bool = True):
        """Run synthesis; returns (cs, fixed_cols, advice_cols, copies)."""
        inputs = inputs or ECDSAInputs.dummy()
        p = self.params
        b = CircuitBuilder(
            num_advice=p.num_advice,
            num_lookup_advice=p.num_lookup_advice,
            lookup_bits=p.lookup_bits,
            check=check,
            balance=p.balance_columns,
        )
        chip = EcdsaChip(b)
        chip.verify(inputs.r, inputs.s, inputs.msghash, inputs.pk)
        if p.expose_msghash:
            for limb in chip.last_m.limbs:
                b.expose_public(limb)
        return b.finalize(p.degree)

    def witness(self, inputs: ECDSAInputs) -> list:
        """Advice column values only (per-proof hot path): the layout is
        witness-independent, so all selector/copy bookkeeping is skipped
        (~2x faster than build; mirrors create_proof's internal
        synthesize-without-keygen, ecdsa_p256.rs:415-423)."""
        p = self.params
        b = CircuitBuilder(
            num_advice=p.num_advice,
            num_lookup_advice=p.num_lookup_advice,
            lookup_bits=p.lookup_bits,
            check=False,
            layout=False,
            balance=p.balance_columns,  # MUST mirror build()'s layout
        )
        chip = EcdsaChip(b)
        chip.verify(inputs.r, inputs.s, inputs.msghash, inputs.pk)
        return b.finalize_values()

    def public_inputs(self, inputs: ECDSAInputs) -> list:
        """Instance columns for create_proof/verify_proof: the msghash's
        88-bit limbs when expose_msghash is set, else none (reference
        parity)."""
        if not self.params.expose_msghash:
            return []
        lb = self.params.limb_bits
        mask = (1 << lb) - 1
        return [[(inputs.msghash >> (lb * i)) & mask
                 for i in range(self.params.num_limbs)]]

    def stats(self) -> dict:
        """Advice/lookup cell counts (the `print_stats` equivalent,
        ecdsa_p256.rs:197-202)."""
        b = CircuitBuilder(
            num_advice=self.params.num_advice,
            num_lookup_advice=self.params.num_lookup_advice,
            lookup_bits=self.params.lookup_bits,
        )
        chip = EcdsaChip(b)
        i = ECDSAInputs.dummy()
        chip.verify(i.r, i.s, i.msghash, i.pk)
        return {
            "gate_cells": [len(c) for c in b.columns],
            "total_gate_cells": sum(len(c) for c in b.columns),
            "lookup_cells": len(b.lookup_values),
            "constants": len(b.const_col),
            "copies": len(b.copies),
        }
