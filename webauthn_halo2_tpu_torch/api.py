"""Library API: the port's `ecdsa_p256.rs` function surface on the card.

The counterpart of the JAX package's api.py (ecdsa_p256.rs:256-469):
download_keys, generate_proof[_evm], verify[_evm] and generate_verifier,
with the same raw 32-byte little-endian field inputs. Keys are
deterministic functions of (circuit params, SRS seed). `proving_key`
keeps them in memory, once per process and device; with a `cache_dir`
(download_keys, and every entry point given the path of an existing key
manifest) it also writes them to that directory once and loads them from
there afterwards (plonk/pk_cache.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

from .circuits.ecdsa_circuit import CircuitParams, ECDSACircuit, ECDSAInputs
from .device import resolve
from .plonk.keygen import ProvingKey, keygen
from .plonk.pk_cache import keygen_cached
from .plonk.prover import create_proof
from .plonk.srs import get_srs
from .plonk.transcript import KeccakRead, KeccakWrite
from .plonk.verifier import verify_proof

KEY_KIND = "webauthn-halo2-tpu-torch-key"

_PK_CACHE: dict = {}


def proving_key(params: CircuitParams | None = None, srs_seed: bytes = b"dev",
                device=None, cache_dir: str | None = None) -> ProvingKey:
    """keygen for the ECDSA circuit at `params` (default CircuitParams,
    k=17), built once per process and device; with `cache_dir`, loaded
    from the key file there, which is written first if it is missing."""
    params = params or CircuitParams()
    dev = resolve(device)
    key = (params.to_json(), srs_seed, str(dev), cache_dir)
    if key not in _PK_CACHE:
        srs = get_srs(params.degree, srs_seed, device=dev)
        circuit = ECDSACircuit(params)
        cs, fixed, _advice, copies = circuit.build(ECDSAInputs.dummy())
        if cache_dir is None:
            _PK_CACHE[key] = keygen(srs, cs, fixed, copies, device=dev)
        else:
            _PK_CACHE[key] = keygen_cached(srs, cs, fixed, copies, cache_dir,
                                           device=dev)
    return _PK_CACHE[key]


def download_keys(degree: int, pk_path: str, vk_path: str,
                  params: CircuitParams | None = None, device=None) -> None:
    """keygen into the directory of `pk_path`, then the key manifests
    (download_keys, ecdsa_p256.rs:256-272)."""
    params = dataclasses.replace(params or CircuitParams(), degree=degree)
    pk = proving_key(params, device=device,
                     cache_dir=os.path.dirname(os.path.abspath(pk_path)))
    manifest = {
        "kind": KEY_KIND,
        "params": json.loads(params.to_json()),
        "srs_seed": "dev",
        "vk_transcript_repr": hex(pk.vk.transcript_repr),
        "created": time.time(),
    }
    for path in (pk_path, vk_path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(manifest, f)


def _load_params(key_path: str) -> CircuitParams:
    if os.path.exists(key_path):
        with open(key_path) as f:
            m = json.load(f)
        if m.get("kind") != KEY_KIND:
            raise ValueError(f"{key_path} is a {m.get('kind')!r} manifest, not {KEY_KIND!r}")
        return CircuitParams(**m["params"])
    return CircuitParams()


def _keys(params: CircuitParams, key_path: str, device) -> ProvingKey:
    """The pk for `params`: from the directory of `key_path` when that
    manifest exists, else in memory."""
    cache_dir = (os.path.dirname(os.path.abspath(key_path))
                 if key_path and os.path.exists(key_path) else None)
    return proving_key(params, device=device, cache_dir=cache_dir)


def le_bytes_to_int(b: bytes | list[int]) -> int:
    return int.from_bytes(bytes(b), "little")


def _prove(r, s, pubkey_x, pubkey_y, msghash, proving_key_path, params,
           device, rng, **opening) -> bytes:
    params = params or _load_params(proving_key_path)
    pk = _keys(params, proving_key_path, device)
    inputs = ECDSAInputs(
        r=le_bytes_to_int(r),
        s=le_bytes_to_int(s),
        msghash=le_bytes_to_int(msghash),
        pk=(le_bytes_to_int(pubkey_x), le_bytes_to_int(pubkey_y)),
    )
    circuit = ECDSACircuit(params)
    advice = circuit.witness(inputs)
    return create_proof(pk, advice, circuit.public_inputs(inputs), rng=rng,
                        device=pk.device, **opening)


def generate_proof(r: bytes, s: bytes, pubkey_x: bytes, pubkey_y: bytes,
                   msghash: bytes, proving_key_path: str = "",
                   params: CircuitParams | None = None, device=None,
                   rng=os.urandom) -> bytes:
    """Blake2b/SHPLONK proof from raw LE byte inputs."""
    return _prove(r, s, pubkey_x, pubkey_y, msghash, proving_key_path,
                  params, device, rng)


def verify(proof: bytes, verifying_key_path: str = "",
           params: CircuitParams | None = None,
           public_inputs: list | None = None, device=None) -> bool:
    """Verify a Blake2b/SHPLONK proof."""
    params = params or _load_params(verifying_key_path)
    pk = _keys(params, verifying_key_path, device)
    return verify_proof(pk.vk, pk.srs, proof, public_inputs or [])


def generate_proof_evm(r: bytes, s: bytes, pubkey_x: bytes, pubkey_y: bytes,
                       msghash: bytes, proving_key_path: str = "",
                       params: CircuitParams | None = None,
                       scheme: str = "gwc", device=None,
                       rng=os.urandom) -> bytes:
    """Keccak(EVM)-transcript proof: GWC (ecdsa_p256.rs:329-377), or
    SHPLONK with scheme="shplonk" (about half the verifier's ecMul gas)."""
    return _prove(r, s, pubkey_x, pubkey_y, msghash, proving_key_path,
                  params, device, rng, scheme=scheme, transcript=KeccakWrite())


def verify_evm(proof: bytes, verifying_key_path: str = "",
               params: CircuitParams | None = None,
               public_inputs: list | None = None,
               scheme: str = "gwc", device=None) -> bool:
    """Verify a Keccak(EVM)-transcript proof, GWC or SHPLONK."""
    params = params or _load_params(verifying_key_path)
    pk = _keys(params, verifying_key_path, device)
    return verify_proof(pk.vk, pk.srs, proof, public_inputs or [],
                        scheme=scheme, transcript=KeccakRead(proof))


def generate_verifier(
    verifying_key_path: str = "",
    sol_code_path: str = "verifier.sol",
    deploy_code_path: str = "verifier.code",
    yul_code_path: str = "verifier.yul",
    valid_proof_hex: str | None = None,
    params: CircuitParams | None = None,
    scheme: str = "gwc",
    device=None,
) -> int | None:
    """EVM verifier codegen (ecdsa_p256.rs:275-327): writes the .yul, .sol
    and .code files; the .code file holds deploy bytecode assembled by
    evm/yul_asm.py. Given a valid proof, deploys the verifier in the
    bytecode EVM (evm/machine.py) and runs the proof with gas metering;
    returns the gas used, else None. Raises RuntimeError when deployment
    or that run fails."""
    from .evm.codegen import generate_verifier as _gen
    from .evm.machine import Chain
    from .evm.yul_asm import compile_yul

    params = params or _load_params(verifying_key_path)
    pk = _keys(params, verifying_key_path, device)
    num_public = params.num_limbs if params.expose_msghash else 0
    yul, sol = _gen(pk.vk, pk.srs, num_public=num_public, scheme=scheme)
    deploy, _runtime = compile_yul(yul)
    gas_used = None
    if valid_proof_hex:
        chain = Chain()
        addr, res = chain.create(0xD0, deploy)
        if not res.success:
            raise RuntimeError("verifier deployment failed")
        run = chain.call(0xD0, addr, bytes.fromhex(valid_proof_hex))
        if not run.success:
            raise RuntimeError("the generated verifier rejected the supplied valid proof")
        gas_used = run.gas_used
    with open(yul_code_path, "w") as f:
        f.write(yul)
    with open(sol_code_path, "w") as f:
        f.write(sol)
    with open(deploy_code_path, "w") as f:
        json.dump({"code": list(deploy)}, f)
    return gas_used
