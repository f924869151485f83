"""The system under test, as the harness drives it: the port's ECDSA-P256
circuit at a configuration's parameters (webauthn_halo2_tpu_torch.api).

Only the ranks' processes and the parent's layout step import the port;
the reference (reference.py) never does.
"""
from __future__ import annotations


class EcdsaSystem:
    def __init__(self, params: dict):
        from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams

        self.params = CircuitParams(**params)

    def proving_key(self, device):
        """The key as an operator's process gets it: `api.proving_key`, with
        the key file and the SRS in $WH2_KEY_DIR and $WH2_SRS_DIR."""
        from webauthn_halo2_tpu_torch import api

        return api.proving_key(self.params, device=device)

    def witnesses(self, requests: list) -> list:
        from webauthn_halo2_tpu_torch import api

        return api.request_witnesses(requests, self.params)

    def prove_batch(self, pk, witnesses: list) -> list:
        from webauthn_halo2_tpu_torch import api

        return api.prove_batch(pk, witnesses)

    def layout(self) -> tuple:
        """(fixed columns, advice columns, copies) of the circuit's synthesis
        on its layout witness, as keygen reads them."""
        from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import ECDSACircuit, ECDSAInputs

        _cs, fixed, advice, copies = ECDSACircuit(self.params).build(ECDSAInputs.dummy())
        return fixed, advice, copies

    @staticmethod
    def verifying_key(pk) -> tuple:
        vk = pk.vk
        return (list(vk.fixed_commitments), list(vk.perm_commitments), int(vk.transcript_repr))
