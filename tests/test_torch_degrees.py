"""The ECDSA circuit across the reference's degree range, k = 11 to 19 (CPU).

The JAX system sizes its circuit for any degree with
`circuits/ecdsa_circuit.auto_params`, places gate regions on the shortest
column at k <= 14 (`CircuitBuilder(balance=True)`), and its sweep
(bench_sweep.py) grows the columns while the build does not fit. Here the
port's copies are held against the JAX package: `auto_params` and the
built circuit (`pk_cache.synthesis_digest` of constraint system, fixed
and advice columns and copies) at k = 11, 14 and 19; the sweep's fit
(`scripts/sweep_torch_degrees.fit_params`) at k = 14, 15 and 16 against the
JAX loop and the JAX rows of results/ecdsa_bench.csv; the key manifest's
params through `api._load_params` and the server's /prove and /verify
(keygen and proving stubbed: no key at k >= 11 on this CPU); the dev
SRS at k = 11, whose monomial points are the committed k = 17 file's
first 2^11 and whose Lagrange points equal the JAX package's
generate_srs(11). The JAX values are stored here; the `slow` test
recomputes them live (about 2 minutes: the JAX package's synthesis at six
degrees and its generate_srs(11), about 25 s).
"""
import dataclasses
import functools
import hashlib
import importlib.util
import json
import pathlib
import random
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from webauthn_halo2_tpu_torch import api
from webauthn_halo2_tpu_torch.circuits.builder import CircuitBuilder
from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import (CircuitParams, ECDSACircuit,
                                                             ECDSAInputs, auto_params)
from webauthn_halo2_tpu_torch.client import webauthn as wa
from webauthn_halo2_tpu_torch.plonk import pk_cache
from webauthn_halo2_tpu_torch.plonk import srs as S
from webauthn_halo2_tpu_torch.plonk.keygen import keygen
from webauthn_halo2_tpu_torch.plonk.pk_cache import synthesis_digest
from webauthn_halo2_tpu_torch.server import app

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_sweep():
    spec = importlib.util.spec_from_file_location(
        "sweep_torch_degrees", ROOT / "scripts" / "sweep_torch_degrees.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _load_sweep()

# The JAX package's auto_params(k) (advice, lookup, lookup_bits, balance;
# the other fields are CircuitParams' defaults) and the synthesis digest of
# ECDSACircuit(auto_params(k)).build(ECDSAInputs.dummy()).
JAX_AUTO = {
    11: ((497, 80, 10, True),
         "e8eb72eb599671cc364263b851a8146b0e0fa62404a40782a5a32320dc576f73"),
    14: ((55, 9, 13, True),
         "99f0b12d904e2311b6932769f51e6f7b0a45cb37e5be8de71d836673957f63dd"),
    19: ((2, 1, 16, False),
         "6a799d6eb01c90e0c4b84d9bb97b631b874f54c24bd7258fd106d0cb32e348af"),
}
# bench_sweep.py's loop in the JAX package: (advice, lookup, balance) it
# settles on, and the builds that did not fit before it.
JAX_FIT = {14: ((55, 9, True), 0), 15: ((28, 5, True), 1), 16: ((13, 2, False), 0)}
# results/ecdsa_bench.csv's k = 15 row has 29/5 columns: what a loop that
# only added columns made (29 unbalanced columns fit); the JAX package's
# loop now tries the balanced placement first and fits 28.
CSV_EARLIER_FIT = {15: (29, 5)}
# the JAX package's constants column at k = 11 (one row a distinct constant)
JAX_K11_CONSTANTS = 5832
# sha256 of the (x, y, z) words of the JAX package's generate_srs(11).g_lag,
# carried into the port's words (convert.point_from_jax)
JAX_SRS11_LAG = "db06dd0c7828f56774a5bd7b5e74b4d4ad03ed6d472eed37f7304466af286480"


def _expected(k: int) -> CircuitParams:
    (na, nl, lb, bal), _ = JAX_AUTO[k]
    return CircuitParams(degree=k, num_advice=na, num_lookup_advice=nl, lookup_bits=lb,
                         balance_columns=bal)


@functools.lru_cache(maxsize=None)
def _auto(k: int) -> CircuitParams:
    return auto_params(k)


@functools.lru_cache(maxsize=None)
def _built(k: int) -> tuple:
    return ECDSACircuit(_auto(k)).build(ECDSAInputs.dummy())


@functools.lru_cache(maxsize=None)
def _srs(k: int) -> S.SRS:
    return S.generate_srs(k, device="cpu")


@pytest.mark.parametrize("k", sorted(JAX_AUTO))
def test_auto_params_and_the_built_circuit_equal_jax(k):
    params = _auto(k)
    assert params == _expected(k)
    assert params.balance_columns == (k <= 14)
    cs, fixed, advice, copies = _built(k)
    assert cs.num_advice == params.num_advice + params.num_lookup_advice
    assert synthesis_digest(cs, fixed, advice, copies) == JAX_AUTO[k][1]
    # every distinct constant has a row of the one constants column
    overlong = {i: len(c) for i, c in enumerate(fixed) if len(c) > 1 << k}
    assert overlong == ({params.num_advice: JAX_K11_CONSTANTS} if k == 11 else {})


def test_keygen_refuses_the_k11_constants_column_as_jax_does():
    """At k = 11 the reference circuit's constants column holds 5,832
    constants, more than 2^11 rows: the JAX package's keygen raises
    ValueError at its packing, and so does the port's, before any work."""
    cs, fixed, _advice, copies = _built(11)
    with pytest.raises(ValueError, match=f"fixed column 497 has {JAX_K11_CONSTANTS} rows"):
        keygen(_srs(11), cs, fixed, copies, device="cpu")


def test_balanced_placement_takes_the_first_shortest_column():
    """The port's heap of column fills places each region where
    min(range(num_advice), key=len(columns[c])) does, ties included."""
    rnd = random.Random(14)
    b = CircuitBuilder(num_advice=37, balance=True, check=False)
    for _ in range(3000):
        want = min(range(b.num_advice), key=lambda c: len(b.columns[c]))
        cells = b.assign_region([rnd.randrange(9) for _ in range(rnd.choice((0, 1, 4, 7, 40)))],
                                [])
        if cells:
            assert cells[0].col == want
        else:
            assert b._shortest() == want


@pytest.mark.parametrize("k", sorted(JAX_FIT))
def test_the_sweep_fit_equals_jax_and_the_reference_csv(k):
    params, misses, overlong = sweep.fit_params(k)
    assert overlong == {}
    (na, nl, bal), nmiss = JAX_FIT[k]
    assert (params.num_advice, params.num_lookup_advice, params.balance_columns) == (na, nl, bal)
    assert len(misses) == nmiss and all("overflow" in m for m in misses)
    csv_columns = {row[:2] for row in sweep.reference_rows()[k]}
    if k in CSV_EARLIER_FIT:
        # the sweep keys and proves the row's own columns beside the fit
        assert csv_columns == {CSV_EARLIER_FIT[k]} != {(na, nl)}
    else:
        assert csv_columns == {(na, nl)}


def test_the_sweep_keeps_the_production_params_at_17():
    params, misses, overlong = sweep.fit_params(17)
    assert params == CircuitParams() and misses == [] and overlong == {}
    assert sweep.reference_rows()[17] == [(7, 1, 2848)] * 2


PROOF = b"\x14" * 8  # what the stubbed prover returns


@pytest.fixture()
def stub_keys(monkeypatch, tmp_path):
    """api without keygen or proving: `proving_key`, the circuit's build, the
    key file and the prover stubbed; records the params each call asked
    for."""
    seen = []
    pk = types.SimpleNamespace(srs=None, device=torch.device("cpu"),
                               vk=types.SimpleNamespace(transcript_repr=0xD5))

    def proving_key(params=None, srs_seed=b"dev", device=None, cache_dir=None):
        seen.append(("proving_key", params, cache_dir))
        return pk

    class Circuit:
        def __init__(self, params):
            self.params = params

        def build(self, inputs=None):
            return None, [], [], []

    monkeypatch.setattr(api, "_PK_CACHE", {})
    monkeypatch.setattr(api, "proving_key", proving_key)
    monkeypatch.setattr(api, "ECDSACircuit", Circuit)
    monkeypatch.setattr(pk_cache, "pk_file", lambda d, *a: str(tmp_path / "keys" / "pk.torch.npz"))
    monkeypatch.setattr(pk_cache, "save_pk", lambda path, key: open(path, "wb").close())
    def witness(circuit, *inputs):
        seen.append(("witness", circuit.params))
        return [], []

    def verify_proof(vk, srs, proof, instances, **kw):
        seen.append(("verify", proof))
        return proof == PROOF

    monkeypatch.setattr(api, "_witness", witness)
    monkeypatch.setattr(api, "create_proof", lambda *a, **kw: PROOF)
    monkeypatch.setattr(api, "verify_proof", verify_proof)
    return seen


@pytest.mark.parametrize("k", [11, 14])
def test_the_key_manifest_keeps_auto_params(k, tmp_path, stub_keys):
    """download_keys(k, ..., params=auto_params(k)) writes a manifest whose
    params come back through _load_params as auto_params(k), with the
    balanced placement; every entry point given the manifest asks for
    those params and the manifest's directory."""
    params = _auto(k)
    pk_path, vk_path = tmp_path / "keys" / "proving_key.pk", tmp_path / "keys" / "verifying_key.vk"
    api.download_keys(k, str(pk_path), str(vk_path), params=params)
    for path in (pk_path, vk_path):
        manifest = json.loads(path.read_text())
        assert manifest["kind"] == api.KEY_KIND and manifest["params"]["balance_columns"]
        assert api._load_params(str(path)) == params
    assert (tmp_path / "keys" / "pk.torch.npz").exists()
    stub_keys.clear()
    proof = api.generate_proof(*[bytes(32)] * 5, proving_key_path=str(pk_path), device="cpu")
    assert api.verify(proof, str(vk_path), device="cpu")
    assert not api.verify(proof[1:], str(vk_path), device="cpu")
    asked = [(p, d) for what, p, d in (e for e in stub_keys if e[0] == "proving_key")]
    assert asked == [(params, str(tmp_path / "keys"))] * 3
    assert ("witness", params) in stub_keys


def test_the_server_proves_and_verifies_at_a_manifest_of_auto_params(tmp_path, stub_keys):
    """/prove and /verify at k = 11 from the manifest's path, as
    tests/test_server_e2e.py has the JAX server do at a degree other than
    17: both take auto_params(11) from the manifest."""
    params = _auto(11)
    pk_path, vk_path = tmp_path / "keys" / "proving_key.pk", tmp_path / "keys" / "verifying_key.vk"
    api.download_keys(11, str(pk_path), str(vk_path), params=params)
    stub_keys.clear()
    cred = wa.create_credential()
    body = wa.prove_request_body(wa.authenticate(cred, b"k=11"), cred,
                                 proving_key_path=str(pk_path))
    srv = app.ThreadingHTTPServer(("127.0.0.1", 0), app.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(route, payload):
        req = urllib.request.Request(base + route, data=json.dumps(payload).encode(),
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            return r.status, r.read().decode()

    try:
        code, proof_hex = post("/prove", body)
        assert (code, proof_hex) == (200, PROOF.hex())
        assert post("/verify", {"verifying_key_path": str(vk_path), "proof": proof_hex}) == (
            200, "verified")
        assert post("/verify", {"verifying_key_path": str(vk_path), "proof": "00"}) == (
            200, "rejected")
    finally:
        srv.shutdown()
        srv.server_close()
    asked = [e[1] for e in stub_keys if e[0] == "proving_key"]
    assert asked == [params] * 3


def _words_digest(point) -> str:
    h = hashlib.sha256()
    for c in point:
        h.update(c.numpy().tobytes())
    return h.hexdigest()


def test_the_k11_srs_is_the_k17_prefix_and_the_jax_lagrange_points():
    srs = _srs(11)
    k17 = S.get_srs(17, device="cpu")
    assert all(torch.equal(a, b[:, :1 << 11]) for a, b in zip(srs.g_mono, k17.g_mono))
    assert _words_digest(srs.g_lag) == JAX_SRS11_LAG
    assert (srs.g2, srs.s_g2) == (k17.g2, k17.s_g2)


@pytest.mark.slow
def test_stored_jax_values_are_current():
    """JAX_AUTO, JAX_FIT and JAX_SRS11_LAG from the JAX package, live."""
    from webauthn_halo2_tpu.circuits import ecdsa_circuit as J
    from webauthn_halo2_tpu.plonk import srs as JS
    from webauthn_halo2_tpu_torch.convert import point_from_jax

    from webauthn_halo2_tpu.plonk.keygen import keygen as jax_keygen

    for k, (cols, digest) in JAX_AUTO.items():
        p = J.auto_params(k)
        assert (p.num_advice, p.num_lookup_advice, p.lookup_bits, p.balance_columns) == cols
        assert dataclasses.asdict(p) == dataclasses.asdict(_expected(k))
        cs, fixed, advice, copies = J.ECDSACircuit(p).build(J.ECDSAInputs.dummy())
        assert synthesis_digest(cs, fixed, advice, copies) == digest
        if k == 11:
            assert len(fixed[p.num_advice]) == JAX_K11_CONSTANTS
            with pytest.raises(ValueError, match="cannot reshape"):
                jax_keygen(types.SimpleNamespace(k=k), cs, fixed, copies)
    for k, (cols, nmiss) in JAX_FIT.items():
        p, misses = J.auto_params(k), 0
        for attempt in range(5):  # bench_sweep.py's loop
            try:
                J.ECDSACircuit(p).build(J.ECDSAInputs.dummy())
                break
            except AssertionError:
                misses += 1
                if not p.balance_columns:
                    p.balance_columns = True
                else:
                    p.num_advice += 1
                    p.num_lookup_advice += attempt == 3
        assert ((p.num_advice, p.num_lookup_advice, p.balance_columns), misses) == (cols, nmiss)
    lag = JS.generate_srs(11).g_lag
    assert _words_digest(point_from_jax(*(np.asarray(c) for c in lag),
                                        device="cpu")) == JAX_SRS11_LAG
