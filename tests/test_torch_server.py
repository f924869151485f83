"""The port's proving server, client, batched proving and the repairs that
serving from threads needs (CPU).

The server's routes answer as the JAX server's do (after
tests/test_server_e2e.py), first with a stubbed api, then the /chain/*
routes with the port's real bundler World over the production k=17
verifier. The port's WebAuthn client gives the JAX client's bytes.
`generate_proofs_batch` runs on the K=6 toy circuit of
tests/test_torch_prover.py (the ECDSA circuit's synthesis and key swapped
out through monkeypatch), each proof equal to one made alone with the same
rng. Then two threads, and two processes, build the kernel libraries
(nvcc, the process and the loader faked) and each source is compiled
once, and one proving key
serves download_keys, every manifest path and the bundler's World.
"""
import json
import pathlib
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from webauthn_halo2_tpu.client import webauthn as jwa
from webauthn_halo2_tpu_torch import api
from webauthn_halo2_tpu_torch.client import webauthn as wa
from webauthn_halo2_tpu_torch.server import app, bundler

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def http_server():
    srv = app.ThreadingHTTPServer(("127.0.0.1", 0), app.Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _request(base: str, route: str, body: dict | None, method: str = "POST"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + route, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _post(base: str, route: str, body: dict) -> tuple[int, str]:
    code, text, _ = _request(base, route, body)
    return code, text


def test_routes_and_schemas(http_server, monkeypatch):
    """The six proving routes with the JAX server's schemas and answers;
    proving is stubbed, so this checks the HTTP and JSON plumbing."""
    calls = {}

    def fake_prove(r, s, px, py, mh, proving_key_path="", **kw):
        calls.setdefault("prove", []).append(
            (bytes(r), bytes(s), bytes(px), bytes(py), bytes(mh), proving_key_path))
        return b"\xab" * 8

    def fake_verifier(*args):
        calls["verifier"] = args
        return 1234

    monkeypatch.setattr(app.api, "generate_proof", fake_prove)
    monkeypatch.setattr(app.api, "generate_proof_evm", fake_prove)
    monkeypatch.setattr(app.api, "verify", lambda proof, *a, **k: proof == b"\xab" * 8)
    monkeypatch.setattr(app.api, "verify_evm", lambda proof, *a, **k: proof == b"\xab" * 8)
    monkeypatch.setattr(app.api, "download_keys",
                        lambda *a, **k: calls.setdefault("setup", a))
    monkeypatch.setattr(app.api, "generate_verifier", fake_verifier)

    assert _post(http_server, "/setup", {"degree": 18}) == (200, "keys generated")
    assert calls["setup"] == (18, "./keys/proving_key.pk", "./keys/verifying_key.vk")
    cred = wa.create_credential()
    body = wa.prove_request_body(wa.authenticate(cred, b"server-test"), cred)
    assert _post(http_server, "/prove", body) == (200, "ab" * 8)
    assert _post(http_server, "/prove_evm/", body) == (200, "ab" * 8)
    want = tuple(bytes(body[k]) for k in ("r", "s", "pubkey_x", "pubkey_y", "msghash"))
    assert calls["prove"] == [want + ("./keys/proving_key.pk",)] * 2
    assert _post(http_server, "/verify", {"verifying_key_path": "", "proof": "ab" * 8}) \
        == (200, "verified")
    assert _post(http_server, "/verify_evm", {"verifying_key_path": "", "proof": "00" * 8}) \
        == (200, "rejected")
    assert _post(http_server, "/generate_evm_verifier", {"valid_proof_hex": "ab"}) \
        == (200, "generated evm verifier (dry-run gas: 1234)")
    assert calls["verifier"] == ("", "verifier.sol", "verifier.code", "verifier.yul", "ab")
    assert _post(http_server, "/nope", {})[0] == 404
    monkeypatch.setattr(app.api, "verify", lambda *a, **k: (_ for _ in ()).throw(ValueError()))
    assert _post(http_server, "/verify", {"verifying_key_path": "", "proof": "zz"})[0] == 500


def test_cors_preflight_and_headers(http_server):
    code, text, headers = _request(http_server, "/prove", None, method="OPTIONS")
    assert (code, text) == (200, "")
    assert headers["Access-Control-Allow-Origin"] == "*"
    assert headers["Access-Control-Allow-Methods"] == "POST, OPTIONS"
    code, _, headers = _request(http_server, "/nope", {})
    assert code == 404 and headers["Access-Control-Allow-Origin"] == "*"


def _production_world():
    from test_torch_chain import production_verifier

    deploy, proof = production_verifier()
    return bundler.World(verifier_deploy=deploy), proof


def test_chain_routes_with_the_port_world(http_server, monkeypatch):
    """/chain/sender, /chain/submit_userop and /chain/receipt on the port's
    World with the production verifier: the JAX World's receipts (gas,
    deployment, counter), 404 for an unknown hash, 500 for bad hex."""
    sys.path.insert(0, str(ROOT / "tests"))
    w, proof = _production_world()
    monkeypatch.setattr(bundler, "_WORLD", w)
    pub = bytes(range(64)).hex()
    code, body = _post(http_server, "/chain/sender", {"public_key": pub})
    assert code == 200
    sender = json.loads(body)["sender"]
    assert _post(http_server, "/chain/sender", {"public_key": pub}) == (200, body)
    receipts = []
    for sig in (proof, proof, bytes(len(proof))):
        code, text, headers = _request(http_server, "/chain/submit_userop",
                                       {"public_key": pub, "proof": sig.hex()})
        assert code == 200 and headers["Content-Type"] == "application/json"
        receipts.append(json.loads(text))
    assert [(r["success"], r["gasUsed"], r["accountDeployed"], r["counterAfter"])
            for r in receipts[:2]] == [(True, 1_105_292, True, 1), (True, 853_489, False, 2)]
    assert not receipts[2]["success"] and receipts[2]["counterAfter"] == 2
    assert {r["sender"] for r in receipts} == {sender}
    code, text = _post(http_server, "/chain/receipt", {"userOpHash": receipts[0]["userOpHash"]})
    assert code == 200 and json.loads(text) == receipts[0]
    code, text = _post(http_server, "/chain/receipt", {"userOpHash": "0x22"})
    assert code == 404 and json.loads(text) == {"error": "unknown userOpHash"}
    code, text = _post(http_server, "/chain/submit_userop", {"public_key": "zz", "proof": ""})
    assert code == 500 and text.startswith("error: ")


CRED = dict(rp_id="webauthn-halo2-tpu.local", credential_id=bytes(range(32)),
            sk=0x1F2E3D4C5B6A79880123456789ABCDEF0123456789ABCDEF0123456789ABCDE)


def _credential(module):
    from webauthn_halo2_tpu_torch.fields.ref_curve import P256_CURVE

    pk = P256_CURVE.mul(CRED["sk"], P256_CURVE.g)
    return module.Credential(CRED["rp_id"], CRED["credential_id"], CRED["sk"], pk)


def test_client_matches_jax():
    """On a fixed credential and nonce: the same registration data,
    assertion bytes, DER, msghash and prove request body."""
    cred, jcred = _credential(wa), _credential(jwa)
    reg = wa.registration_authenticator_data(cred)
    assert reg == jwa.registration_authenticator_data(jcred)
    assert wa.parse_authenticator_data(reg) == jwa.parse_authenticator_data(reg)
    assert wa.parse_authenticator_data(reg)["publicKey"] == cred.pk
    for challenge, nonce in ((b"challenge", 12345), (b"\x00" * 32, 2 ** 200 + 7)):
        a = wa.authenticate(cred, challenge, k=nonce)
        b = jwa.authenticate(jcred, challenge, k=nonce)
        assert (a.authenticator_data, a.client_data_json, a.der_signature, a.msghash,
                a.r, a.s) == (b.authenticator_data, b.client_data_json, b.der_signature,
                              b.msghash, b.r, b.s)
        assert wa.der_parse_signature(a.der_signature) == (a.r, a.s)
        assert wa.prove_request_body(a, cred) == jwa.prove_request_body(b, jcred)
        assert wa.verify_assertion_host(a, cred)
        assert wa.es256_inputs_from_assertion(a, cred).authenticator_data == a.authenticator_data
    assert wa.cbor_decode_first(wa.cbor_encode(cred.cose_key)) == \
        jwa.cbor_decode_first(jwa.cbor_encode(jcred.cose_key))


def _toy_key():
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_prover import JAX_REF, _det_rng, _keyed_and_proved, toy_inputs

    from webauthn_halo2_tpu_torch.plonk import cs as CS

    _, pk, _, _ = _keyed_and_proved("toy")
    _, _, advice, instances, _ = toy_inputs(CS)
    return pk, advice, instances, JAX_REF["toy"], _det_rng


def test_generate_proofs_batch_equals_proofs_made_alone(monkeypatch):
    """Three requests through generate_proofs_batch on the K=6 toy circuit
    (its key and witness in place of the ECDSA circuit's): the two with
    the toy seed's rng give the stored JAX proof, the third the proof that
    create_proof makes alone with its rng."""
    from webauthn_halo2_tpu_torch.plonk.prover import create_proof

    pk, advice, instances, ref, det_rng = _toy_key()
    seen = []
    monkeypatch.setattr(api, "_keys", lambda params, path, device: pk)
    monkeypatch.setattr(api, "ECDSACircuit", lambda params: "toy")

    def witness(circuit, r, s, px, py, mh):
        seen.append((circuit, bytes(r)))
        return advice, instances

    monkeypatch.setattr(api, "_witness", witness)
    requests = [dict(r=[i] * 32, s=[0] * 32, pubkey_x=[0] * 32, pubkey_y=[0] * 32,
                     msghash=[0] * 32) for i in range(3)]
    rngs = [det_rng(ref["seed"]), det_rng(b"batch"), det_rng(ref["seed"])]
    proofs = api.generate_proofs_batch(requests, params=api.CircuitParams(), device="cpu",
                                       rngs=rngs)
    assert seen == [("toy", bytes([i] * 32)) for i in range(3)]
    assert proofs[0].hex() == proofs[2].hex() == ref["proof"]
    assert proofs[1] != proofs[0]
    assert proofs[1] == create_proof(pk, advice, instances, rng=det_rng(b"batch"),
                                     device="cpu")


def test_prove_batch_checks_its_arguments():
    with pytest.raises(ValueError, match="scheme"):
        api.prove_batch(object(), [lambda: ([], [])], scheme="plonk")
    with pytest.raises(ValueError, match="rngs"):
        api.prove_batch(object(), [lambda: ([], [])] * 2, rngs=[None])
    assert api.prove_batch(object(), []) == []


def test_kernel_build_compiles_each_source_once_under_threads(tmp_path, monkeypatch):
    """Two threads ask for kernel libraries at once (nvcc, its process and
    the loader faked): each source is compiled once, and every library is
    loaded from a finished file."""
    from webauthn_halo2_tpu_torch.ops import kernels as K

    compiled, loaded = [], []

    class FakeNvcc:
        def __init__(self, cmd, stdout=None, stderr=None):
            self.out = pathlib.Path(cmd[cmd.index("-o") + 1])
            compiled.append(pathlib.Path(cmd[-1]).stem)
            self.polls = 0

        def poll(self):
            self.polls += 1
            if self.polls < 4:  # still compiling: the other thread runs meanwhile
                return None
            self.out.write_bytes(b"library")
            return 0

    def fake_cdll(path):
        assert pathlib.Path(path).read_bytes() == b"library"
        loaded.append(pathlib.Path(path).name)
        return object()

    monkeypatch.setattr(K, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(K, "_STATE", K._Libraries())
    monkeypatch.setattr(K, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(K.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(K.ctypes, "CDLL", fake_cdll)
    got, errors = [], []

    def ask(name):
        try:
            got.append(K.lib(name))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=ask, args=(n,)) for n in ("montmul", "ntt")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and len(got) == 2
    assert sorted(compiled) == sorted(K.SOURCES)
    assert len(loaded) == len(K.SOURCES)
    assert not list(tmp_path.glob("*.tmp"))


# One process of the test below: the kernel build with nvcc and the loader
# faked, started when both processes are ready; prints the libraries loaded.
_BUILD_IN_A_PROCESS = r"""
import os, pathlib, sys, time
sys.path.insert(0, sys.argv[2])
from webauthn_halo2_tpu_torch.ops import kernels as K

tmp = pathlib.Path(sys.argv[1])


class FakeNvcc:
    def __init__(self, cmd, stdout=None, stderr=None):
        self.out = pathlib.Path(cmd[cmd.index("-o") + 1])
        with open(tmp / "compiled", "a") as f:
            f.write(pathlib.Path(cmd[-1]).stem + "\n")
        self.t0 = time.time()

    def poll(self):
        if time.time() - self.t0 < 0.5:  # still compiling: the other process runs meanwhile
            return None
        self.out.write_bytes(b"library")
        return 0


def fake_cdll(path):
    assert pathlib.Path(path).read_bytes() == b"library"
    return object()


K.BUILD_DIR = tmp / "kernels"
K._nvcc = lambda: "nvcc"
K.subprocess.Popen = FakeNvcc
K.ctypes.CDLL = fake_cdll
(tmp / f"ready.{os.getpid()}").touch()
while len(list(tmp.glob("ready.*"))) < 2:
    time.sleep(0.01)
K.build_all()
print(len(K._STATE.libs))
"""


def test_kernel_build_compiles_each_source_once_across_processes(tmp_path):
    """Two processes build the kernel libraries at once (the ranks of a
    sharded prover; nvcc and the loader faked): the file lock of each
    library lets one process compile it and the other load its file."""
    import subprocess

    from webauthn_halo2_tpu_torch.ops import kernels as K

    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_IN_A_PROCESS, str(tmp_path),
                               str(ROOT)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == [str(len(K.SOURCES))] * 2
    compiled = (tmp_path / "compiled").read_text().split()
    assert sorted(compiled) == sorted(K.SOURCES)
    assert not list((tmp_path / "kernels").glob("*.tmp"))


class _FakeKey:
    def __init__(self, srs):
        self.srs = srs
        self.vk = type("VK", (), {"transcript_repr": 0xABC})()


def _stub_keygen(monkeypatch, tmp_path):
    """api's keygen stack with the circuit, the SRS, keygen and the key
    file faked; returns the counts of keygen, save and load calls."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_prover import toy_inputs

    from webauthn_halo2_tpu_torch.plonk import cs as CS
    from webauthn_halo2_tpu_torch.plonk import pk_cache

    counts = {"keygen": 0, "save": 0, "load": 0}
    srs = type("SRS", (), {"k": 6, "tau_seed": b"dev"})()

    class Circuit:
        def __init__(self, params):
            pass

        def build(self, inputs):
            cs, fixed, advice, _, copies = toy_inputs(CS)
            return cs, fixed, advice, copies

    def keygen(srs_, cs, fixed, copies, device=None):
        counts["keygen"] += 1
        time.sleep(0.2)  # long enough for a second thread to arrive
        return _FakeKey(srs_)

    def save(path, pk):
        counts["save"] += 1
        pathlib.Path(path).write_bytes(b"key")

    def load(path, srs_, cs, device=None):
        counts["load"] += 1
        return _FakeKey(srs_)

    monkeypatch.setattr(api, "_PK_CACHE", {})
    monkeypatch.setattr(api, "get_srs", lambda k, seed, device=None: srs)
    monkeypatch.setattr(api, "ECDSACircuit", Circuit)
    monkeypatch.setattr(api, "keygen", keygen)
    monkeypatch.setattr(pk_cache, "keygen", keygen)
    monkeypatch.setattr(pk_cache, "save_pk", save)
    monkeypatch.setattr(pk_cache, "load_pk", load)
    monkeypatch.chdir(tmp_path)
    return counts


def test_one_proving_key_per_circuit(tmp_path, monkeypatch):
    """download_keys, the "" path, the manifest path, two threads at once
    and the bundler's World share one key, built once."""
    counts = _stub_keygen(monkeypatch, tmp_path)
    params = api.CircuitParams()
    keys = []
    threads = [threading.Thread(target=lambda: keys.append(api._keys(params, "", "cpu")))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    api.download_keys(17, "./keys/proving_key.pk", "./keys/verifying_key.vk", device="cpu")
    keys.append(api._keys(params, "./keys/proving_key.pk", "cpu"))
    keys.append(api._keys(params, "", "cpu"))
    # download_keys saved the key that was in memory: one file, no reload
    assert counts == {"keygen": 1, "save": 1, "load": 0}
    assert len(list((tmp_path / "keys").glob("pk_k6_*.torch.npz"))) == 1
    manifest = json.loads((tmp_path / "keys" / "verifying_key.vk").read_text())
    assert manifest["kind"] == api.KEY_KIND and manifest["vk_transcript_repr"] == "0xabc"
    from test_torch_chain import production_verifier

    deploy, _ = production_verifier()
    given = []
    import webauthn_halo2_tpu_torch.evm.codegen as codegen

    monkeypatch.setattr(codegen, "generate_verifier",
                        lambda vk, srs, num_public=0: given.append(vk) or ("yul", "sol"))
    monkeypatch.setattr(bundler, "compile_yul", lambda yul: (deploy, b""))
    bundler.World(device="cpu")
    assert given == [keys[0].vk]
    assert all(k is keys[0] for k in keys) and len(keys) == 4
    assert counts["keygen"] == 1


def test_download_keys_writes_the_file_of_a_fresh_key(tmp_path, monkeypatch):
    """With no key in memory, download_keys builds it through the key
    file: keygen and save once; a second process-fresh call loads it."""
    counts = _stub_keygen(monkeypatch, tmp_path)
    api.download_keys(17, "./keys/proving_key.pk", "./keys/verifying_key.vk", device="cpu")
    assert counts == {"keygen": 1, "save": 1, "load": 0}
    api._PK_CACHE.clear()
    api.download_keys(17, "./keys/proving_key.pk", "./keys/verifying_key.vk", device="cpu")
    assert counts == {"keygen": 1, "save": 1, "load": 1}
