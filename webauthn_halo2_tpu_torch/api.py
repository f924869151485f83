"""Library API: the port's generate_proof / verify on the card.

The counterpart of the JAX package's api.py for its main path: a
Blake2b/SHPLONK proof of the ECDSA-P256 circuit, with the same raw 32-byte
little-endian field inputs. Keys are deterministic functions of (circuit
params, SRS seed) and are rebuilt once per process and device, then kept in
memory. `verify_evm` verifies a Keccak-transcript proof (such as the JAX
package's results/proof_shplonk_k17.hex).
"""
from __future__ import annotations

import json
import os

from .circuits.ecdsa_circuit import CircuitParams, ECDSACircuit, ECDSAInputs
from .device import resolve
from .plonk.keygen import ProvingKey, keygen
from .plonk.prover import create_proof
from .plonk.srs import get_srs
from .plonk.verifier import verify_proof

_PK_CACHE: dict = {}


def proving_key(params: CircuitParams | None = None, srs_seed: bytes = b"dev",
                device=None) -> ProvingKey:
    """keygen for the ECDSA circuit at `params` (default CircuitParams,
    k=17), built once per process and device."""
    params = params or CircuitParams()
    dev = resolve(device)
    key = (params.to_json(), srs_seed, str(dev))
    if key not in _PK_CACHE:
        srs = get_srs(params.degree, srs_seed, device=dev)
        circuit = ECDSACircuit(params)
        cs, fixed, _advice, copies = circuit.build(ECDSAInputs.dummy())
        _PK_CACHE[key] = keygen(srs, cs, fixed, copies, device=dev)
    return _PK_CACHE[key]


def _load_params(key_path: str) -> CircuitParams:
    if os.path.exists(key_path):
        with open(key_path) as f:
            m = json.load(f)
        return CircuitParams(**m["params"])
    return CircuitParams()


def le_bytes_to_int(b: bytes | list[int]) -> int:
    return int.from_bytes(bytes(b), "little")


def generate_proof(r: bytes, s: bytes, pubkey_x: bytes, pubkey_y: bytes,
                   msghash: bytes, proving_key_path: str = "",
                   params: CircuitParams | None = None, device=None,
                   rng=os.urandom) -> bytes:
    """Blake2b/SHPLONK proof from raw LE byte inputs."""
    params = params or _load_params(proving_key_path)
    pk = proving_key(params, device=device)
    inputs = ECDSAInputs(
        r=le_bytes_to_int(r),
        s=le_bytes_to_int(s),
        msghash=le_bytes_to_int(msghash),
        pk=(le_bytes_to_int(pubkey_x), le_bytes_to_int(pubkey_y)),
    )
    circuit = ECDSACircuit(params)
    advice = circuit.witness(inputs)
    return create_proof(pk, advice, circuit.public_inputs(inputs), rng=rng,
                        device=pk.device)


def verify(proof: bytes, verifying_key_path: str = "",
           params: CircuitParams | None = None,
           public_inputs: list | None = None, device=None) -> bool:
    """Verify a Blake2b/SHPLONK proof."""
    params = params or _load_params(verifying_key_path)
    pk = proving_key(params, device=device)
    return verify_proof(pk.vk, pk.srs, proof, public_inputs or [])


def verify_evm(proof: bytes, verifying_key_path: str = "",
               params: CircuitParams | None = None,
               public_inputs: list | None = None,
               scheme: str = "gwc", device=None) -> bool:
    """Verify a Keccak(EVM)-transcript proof, GWC or SHPLONK."""
    from .plonk.transcript import KeccakRead

    params = params or _load_params(verifying_key_path)
    pk = proving_key(params, device=device)
    return verify_proof(pk.vk, pk.srs, proof, public_inputs or [],
                        scheme=scheme, transcript=KeccakRead(proof))
