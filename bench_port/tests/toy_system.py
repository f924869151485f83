"""A toy system for the benchmark's CPU tests: the port's flex-gate builder
at k = 6 (two gate columns, one lookup column, a 4-bit table), whose
witness carries a request's five inputs as 88-bit limbs the way the ECDSA
circuit loads them, with a few gates, copies, lookups and a constant
around them. Its witness raises where the ECDSA circuit's does, on a
signature outside the circuit's domain. It has the ECDSA system's interface (bp/system.py) and runs
the port's keygen and prover on the CPU.
"""
from __future__ import annotations

import functools
import os

NAMES = ("msghash", "r", "s", "pubkey_x", "pubkey_y")
PARAMS = dict(degree=6, num_advice=2, num_lookup_advice=1, lookup_bits=4)


def _limbs(x: int) -> list:
    return [(x >> (88 * i)) & ((1 << 88) - 1) for i in range(3)]


def _value(req: dict, name: str) -> int:
    return int.from_bytes(bytes(req[name]), "little")


DUMMY = {name: list((7 * i + 1).to_bytes(32, "little")) for i, name in enumerate(NAMES)}


class ToySystem:
    def __init__(self, params: dict):
        self.p = dict(PARAMS, **{k: params[k] for k in PARAMS if k in params})

    def _builder(self, layout: bool):
        from webauthn_halo2_tpu_torch.circuits.builder import CircuitBuilder

        return CircuitBuilder(num_advice=self.p["num_advice"],
                              num_lookup_advice=self.p["num_lookup_advice"],
                              lookup_bits=self.p["lookup_bits"], check=layout, layout=layout)

    def _synthesize(self, b, req: dict) -> dict:
        cells = {name: b.load_witnesses(_limbs(_value(req, name))) for name in NAMES}
        acc = b.mul_add(cells["r"][0], cells["s"][0], cells["msghash"][0])
        acc = b.add(acc, cells["pubkey_x"][1])
        b.mul(acc, cells["pubkey_y"][2])
        small = b.load_witnesses([_value(req, "r") & 15, _value(req, "s") & 15])
        for c in small:
            b.raw_lookup(c)
        b.load_constant(5)
        return cells

    def inputs(self) -> dict:
        """The cells of the five inputs' limbs, as a configuration names them."""
        b = self._builder(True)
        cells = self._synthesize(b, DUMMY)
        return {name: [[c.col, c.row] for c in cells[name]] for name in NAMES}

    def layout(self) -> tuple:
        b = self._builder(True)
        self._synthesize(b, DUMMY)
        _cs, fixed, advice, copies = b.finalize(self.p["degree"])
        return fixed, advice, copies

    def proving_key(self, device):
        from webauthn_halo2_tpu_torch.plonk.pk_cache import keygen_cached
        from webauthn_halo2_tpu_torch.plonk.srs import get_srs

        b = self._builder(True)
        self._synthesize(b, DUMMY)
        cs, fixed, _advice, copies = b.finalize(self.p["degree"])
        srs = get_srs(self.p["degree"], device=device)
        return keygen_cached(srs, cs, fixed, copies, os.environ["WH2_KEY_DIR"], device=device)

    def _witness(self, req: dict) -> tuple:
        from bp.reference import in_domain

        if not in_domain(req):  # as the ECDSA circuit's witness does there
            raise ValueError("base is not invertible")
        b = self._builder(False)
        self._synthesize(b, req)
        return b.finalize_values(), []

    def witnesses(self, requests: list) -> list:
        return [functools.partial(self._witness, req) for req in requests]

    def prove_batch(self, pk, witnesses: list) -> list:
        from webauthn_halo2_tpu_torch import api

        return api.prove_batch(pk, witnesses)

    @staticmethod
    def verifying_key(pk) -> tuple:
        vk = pk.vk
        return (list(vk.fixed_commitments), list(vk.perm_commitments), int(vk.transcript_repr))
