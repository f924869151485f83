"""Library API: the port's `ecdsa_p256.rs` function surface on the card.

The counterpart of the JAX package's api.py (ecdsa_p256.rs:256-469):
download_keys, generate_proof[_evm], verify[_evm], generate_verifier and
generate_proofs_batch, with the same raw 32-byte little-endian field
inputs. Keys are deterministic functions of (circuit params, SRS seed).
`proving_key` keeps one key per circuit, SRS seed and device in memory,
built once per process under a lock, whichever thread asks first; when a
key is not yet in memory and a `cache_dir` is given (download_keys, and
every entry point given the path of an existing key manifest), or else
$WH2_KEY_DIR is set, it is loaded from the key file in that directory,
which is written first if it is missing (plonk/pk_cache.py). With
neither, the key lives in memory only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys
import threading
import time

from .circuits.ecdsa_circuit import CircuitParams, ECDSACircuit, ECDSAInputs
from .device import resolve, tracing
from .plonk.keygen import ProvingKey, keygen
from .plonk import pk_cache
from .plonk.pk_cache import keygen_cached
from .plonk.prover import _fused_for, create_proof
from .plonk.srs import get_srs
from .plonk.transcript import KeccakRead, KeccakWrite
from .plonk.verifier import verify_proof

KEY_KIND = "webauthn-halo2-tpu-torch-key"

_PK_CACHE: dict = {}
_PK_LOCK = threading.Lock()


def proving_key(params: CircuitParams | None = None, srs_seed: bytes = b"dev",
                device=None, cache_dir: str | None = None) -> ProvingKey:
    """keygen for the ECDSA circuit at `params` (default CircuitParams,
    k=17), once per process, SRS seed and device, whatever `cache_dir`:
    with `cache_dir`, or when it is None with $WH2_KEY_DIR (read at each
    call) set, a key not yet in memory is loaded from the key file in that
    directory, which is written first if it is missing."""
    params = params or CircuitParams()
    dev = resolve(device)
    cache_dir = pk_cache.key_dir(cache_dir)
    key = (params.to_json(), srs_seed, str(dev))
    with _PK_LOCK:
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
    """keygen into the directory of `pk_path` (the key file is saved there
    also when the key was already in memory), then the key manifests
    (download_keys, ecdsa_p256.rs:256-272)."""
    params = dataclasses.replace(params or CircuitParams(), degree=degree)
    key_dir = os.path.dirname(os.path.abspath(pk_path))
    pk = proving_key(params, device=device, cache_dir=key_dir)
    cs, fixed, _advice, copies = ECDSACircuit(params).build(ECDSAInputs.dummy())
    path = pk_cache.pk_file(key_dir, pk.srs, cs, fixed, copies)
    if not os.path.exists(path):
        os.makedirs(key_dir, exist_ok=True)
        pk_cache.save_pk(path, pk)
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
    manifest exists, else as `proving_key` keeps it without a directory."""
    cache_dir = (os.path.dirname(os.path.abspath(key_path))
                 if key_path and os.path.exists(key_path) else None)
    return proving_key(params, device=device, cache_dir=cache_dir)


def le_bytes_to_int(b: bytes | list[int]) -> int:
    return int.from_bytes(bytes(b), "little")


def _prove(r, s, pubkey_x, pubkey_y, msghash, proving_key_path, params,
           device, rng, **opening) -> bytes:
    params = params or _load_params(proving_key_path)
    pk = _keys(params, proving_key_path, device)
    circuit = ECDSACircuit(params)
    advice, instances = _witness(circuit, r, s, pubkey_x, pubkey_y, msghash)
    proof = create_proof(pk, advice, instances, rng=rng, device=pk.device, **opening)
    if tracing():
        from .plonk.prover import LAST_SPANS
        from .utils import roofline

        # the advice MSM counted dense (an upper count, marked): counting
        # its digits would add most of a second to the traced proof
        model = roofline.proof_work_model(pk, opening.get("scheme", "shplonk"))
        print(roofline.format_report(roofline.report(LAST_SPANS, model)),
              file=sys.stderr, flush=True)
    return proof


def _witness(circuit: ECDSACircuit, r, s, pubkey_x, pubkey_y, msghash) -> tuple:
    """(advice, instances) of the circuit for one signature's LE bytes."""
    inputs = ECDSAInputs(
        r=le_bytes_to_int(r),
        s=le_bytes_to_int(s),
        msghash=le_bytes_to_int(msghash),
        pk=(le_bytes_to_int(pubkey_x), le_bytes_to_int(pubkey_y)),
    )
    return circuit.witness(inputs), circuit.public_inputs(inputs)


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


def _opening(scheme: str) -> dict:
    """create_proof's options for a batch scheme: "shplonk" is SHPLONK over
    Blake2b (generate_proof), "gwc" GWC over Keccak (generate_proof_evm)."""
    if scheme == "shplonk":
        return {}
    if scheme == "gwc":
        return dict(scheme="gwc", transcript=KeccakWrite())
    raise ValueError(f"unknown batch scheme {scheme!r}")


_PROVERS = 2  # create_proof workers of a batch
_STREAMS: dict = {}


def _prover_streams(dev) -> tuple:
    """The batch provers' CUDA streams on `dev`, made once per process."""
    with _PK_LOCK:
        if str(dev) not in _STREAMS:
            import torch

            _STREAMS[str(dev)] = tuple(torch.cuda.Stream(dev) for _ in range(_PROVERS))
        return _STREAMS[str(dev)]


def prove_batch(pk: ProvingKey, witnesses: list, scheme: str = "shplonk",
                rngs: list | None = None) -> list[bytes]:
    """N independent proofs over one pk. `witnesses` are callables, each
    returning (advice, instances); one worker runs them in order, and two
    create_proof workers prove what it hands on, each proof with its own
    `rngs[i]` (default os.urandom). On a card each prover thread runs on a
    stream of its own (every kernel wrapper launches on the current
    stream), one of two kept per device for the process, so the caching
    allocator reuses each stream's freed blocks from proof to proof. Before
    each proof the stream waits for the caller's stream, where the key and
    its stacked tensors were built; the provers only read those. Untraced,
    a proof waits only for its own stream, so one prover's host work can
    run while the other's kernels occupy the card. The provers share the
    launch counters and, under WH2_TRACE, `prover.LAST_SPANS`, which are
    then the batch's and not one proof's. Every worker thread makes the
    key's card its current device as it starts (torch keeps a current
    device a thread, and a new thread starts on card 0), so the whole
    batch runs on `pk.device`, whichever card the caller's thread is on."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    rngs = rngs or [os.urandom] * len(witnesses)
    if len(rngs) != len(witnesses):
        raise ValueError(f"{len(rngs)} rngs for {len(witnesses)} witnesses")
    _opening(scheme)  # an unknown scheme raises before any work starts
    if not witnesses:
        return []
    dev = pk.device
    _fused_for(pk)  # the key's stacks, built here before any prover reads them
    origin = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    free = list(_prover_streams(dev)) if origin is not None else []
    worker = threading.local()

    def on_key_card():  # once per worker thread
        if dev.type == "cuda":
            torch.cuda.set_device(dev)

    def take_stream():  # once per prover thread
        on_key_card()
        if free:
            worker.stream = free.pop()

    def prove(args, rng):
        advice, instances = args
        on_stream = contextlib.nullcontext()
        if origin is not None:
            worker.stream.wait_stream(origin)
            on_stream = torch.cuda.stream(worker.stream)
        with on_stream:
            return create_proof(pk, advice, instances, rng=rng, device=dev,
                                **_opening(scheme))

    with ThreadPoolExecutor(max_workers=1, initializer=on_key_card) as wpool, \
            ThreadPoolExecutor(max_workers=_PROVERS, initializer=take_stream) as ppool:
        wfuts = [wpool.submit(w) for w in witnesses]
        pfuts = [ppool.submit(prove, f.result(), rng) for f, rng in zip(wfuts, rngs)]
        return [f.result() for f in pfuts]


def generate_proofs_batch(
    requests: list[dict],
    proving_key_path: str = "",
    params: CircuitParams | None = None,
    scheme: str = "shplonk",
    device=None,
    rngs: list | None = None,
) -> list[bytes]:
    """Batched multi-signature proving: N independent signatures, N proofs
    over one proving key. Each request is {r, s, pubkey_x, pubkey_y,
    msghash} as LE byte lists (ProveRequestBody). Witness generation runs
    in one worker while two create_proof workers prove (`prove_batch`), so
    one proof's host work can run while the other's kernels occupy the
    card. scheme="shplonk": SHPLONK over Blake2b; "gwc": GWC over Keccak."""
    params = params or _load_params(proving_key_path)
    pk = _keys(params, proving_key_path, device)
    return prove_batch(pk, request_witnesses(requests, params), scheme, rngs)


def request_witnesses(requests: list[dict], params: CircuitParams | None = None) -> list:
    """The witnesses of `prove_batch` for ProveRequestBody-style requests
    ({r, s, pubkey_x, pubkey_y, msghash} as LE byte lists): callables, each
    returning (advice, instances) of the ECDSA circuit at `params`."""
    circuit = ECDSACircuit(params or CircuitParams())
    return [functools.partial(_witness, circuit, req["r"], req["s"], req["pubkey_x"],
                              req["pubkey_y"], req["msghash"])
            for req in requests]
