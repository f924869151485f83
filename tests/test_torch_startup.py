"""The port's start-up (CPU): the SRS and key directories, the start-up
profile and the build cache's cleaner.

WH2_SRS_DIR: get_srs generates a degree into it, loads it from there once
the in-memory cache is cleared, and the committed and build/srs/ paths
stay when it is unset. WH2_KEY_DIR: api.proving_key keeps the key file
there, made once and then loaded (keygen, the circuit and the key file
faked as tests/test_torch_server.py fakes them); unset, nothing is
written. scripts/profile_torch_keygen.py's steps on the K=6 toy circuit
of tests/test_torch_prover.py: every step reported, the proof equal to
the JAX package's stored toy proof and from the key loaded equal to the
proof from the key made, then a second start-up that loads the key.
scripts/gc_torch_builds.py on a temporary build tree: stale libraries and
orphaned temporary files go, current libraries and .lock files stay.
"""
import fcntl
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from webauthn_halo2_tpu_torch import api
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk import pk_cache
from webauthn_halo2_tpu_torch.plonk import srs as S

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_prover import JAX_REF, K, toy_inputs  # noqa: E402


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_srs_dir_holds_both_formats_and_a_generated_srs(tmp_path, monkeypatch):
    monkeypatch.setattr(S, "_SRS_MEM_CACHE", {})
    monkeypatch.setenv("WH2_TRACE", "1")  # a generated SRS carries its spans
    monkeypatch.delenv("WH2_SRS_DIR", raising=False)
    committed, generated = S.srs_paths(5)
    assert (pathlib.Path(committed).parent, pathlib.Path(generated).parent) == (
        ROOT / "artifacts", ROOT / "build" / "srs")
    monkeypatch.setenv("WH2_SRS_DIR", str(tmp_path))
    name = "srs_bn254_k5_646576"
    assert S.srs_paths(5) == (str(tmp_path / f"{name}.npz"),
                              str(tmp_path / f"{name}.torch.npz"))
    assert S.srs_paths(5, cache_dir="elsewhere")[1] == f"elsewhere/{name}.torch.npz"
    srs = S.get_srs(5, device="cpu")
    assert srs.spans and [p.name for p in tmp_path.iterdir()] == [f"{name}.torch.npz"]
    S._SRS_MEM_CACHE.clear()
    again = S.get_srs(5, device="cpu")
    assert again is not srs and not again.spans  # loaded, not generated
    assert all(torch.equal(a, b) for a, b in zip((*again.g_mono, *again.g_lag),
                                                  (*srs.g_mono, *srs.g_lag)))
    # the committed k=6 SRS is not looked for outside the directory
    assert not any(pathlib.Path(p).exists() for p in S.srs_paths(6))


class _FakeKey:
    def __init__(self, srs):
        self.srs = srs
        self.vk = type("VK", (), {"transcript_repr": 0xABC})()


def _stub_keygen(monkeypatch, tmp_path) -> dict:
    """api's keygen with the circuit, the SRS, keygen and the key file faked
    on the toy circuit; returns the counts of keygen, save and load."""
    counts = {"keygen": 0, "save": 0, "load": 0}
    srs = type("SRS", (), {"k": K, "tau_seed": b"dev"})()

    class Circuit:
        def __init__(self, params):
            pass

        def build(self, inputs):
            cs, fixed, advice, _, copies = toy_inputs(CS)
            return cs, fixed, advice, copies

    def keygen(srs_, cs, fixed, copies, device=None):
        counts["keygen"] += 1
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


def test_key_dir_keeps_the_key_file_and_loads_it(tmp_path, monkeypatch):
    counts = _stub_keygen(monkeypatch, tmp_path)
    keys = tmp_path / "key dir"
    monkeypatch.setenv("WH2_KEY_DIR", str(keys))
    pk = api.proving_key(device="cpu")
    assert counts == {"keygen": 1, "save": 1, "load": 0}
    cs, fixed, _, _, copies = toy_inputs(CS)
    path = pathlib.Path(pk_cache.pk_file(str(keys), pk.srs, cs, fixed, copies))
    assert [p.name for p in keys.iterdir()] == [path.name]
    assert path.name.startswith(f"pk_k{K}_") and path.name.endswith(".torch.npz")
    assert api.proving_key(device="cpu") is pk  # in memory: no second load
    api._PK_CACHE.clear()  # a restarted process
    api.proving_key(device="cpu")
    assert counts == {"keygen": 1, "save": 1, "load": 1}
    # a manifest's directory wins over WH2_KEY_DIR
    api._PK_CACHE.clear()
    api.download_keys(17, "./manifests/pk.json", "./manifests/vk.json", device="cpu")
    assert counts == {"keygen": 2, "save": 2, "load": 1}
    assert sorted(p.name for p in (tmp_path / "manifests").iterdir()) == sorted(
        ["pk.json", "vk.json", path.name])


def test_without_key_dir_the_key_stays_in_memory(tmp_path, monkeypatch):
    counts = _stub_keygen(monkeypatch, tmp_path)
    monkeypatch.delenv("WH2_KEY_DIR", raising=False)
    assert pk_cache.key_dir() is None and pk_cache.key_dir("d") == "d"
    api.proving_key(device="cpu")
    assert counts == {"keygen": 1, "save": 0, "load": 0}
    assert list(tmp_path.iterdir()) == []


def test_profile_startup_on_the_toy_circuit(tmp_path, monkeypatch):
    """The profile's steps on the K=6 toy circuit: made key, then a second
    start-up from the key file (its proofs faked: the toy proofs cost
    seconds each on the CPU)."""
    profile = _script("profile_torch_keygen")
    from webauthn_halo2_tpu_torch.plonk import prover

    monkeypatch.setattr(S, "_SRS_MEM_CACHE", {})
    monkeypatch.setenv("WH2_TRACE", "1")  # keygen's spans
    monkeypatch.delenv("WH2_SRS_DIR", raising=False)
    cs, fixed, advice, instances, copies = toy_inputs(CS)
    lines = []

    def run():
        return profile.profile_startup(
            K, lambda: (cs, fixed, advice, copies), lambda: (advice, instances),
            str(tmp_path), device="cpu", rng_seed=JAX_REF["toy"]["seed"], log=lines.append)

    first = run()
    assert [r["step"] for r in first["steps"]] == list(profile.STEPS)
    assert all(r["wall_s"] >= 0 and r["device_s"] is None for r in first["steps"])
    assert (first["srs"], first["key"]) == ("loaded", "made") and first["keygen_spans"]
    # steps 3-4 are keygen_cached's work: a made key is saved, not reloaded;
    # the reload that proof 2 checks is timed apart, outside the start-up
    assert "save_s" in first["steps"][3] and "load_s" not in first["steps"][3]
    assert first["reload"]["step"] == "key reload (check)"
    assert first["startup_s"] == sum(r["wall_s"] for r in first["steps"][:4])
    assert first["steps"][-1]["ok"] and first["proof_hex"] == JAX_REF["toy"]["proof"]
    assert int(first["vk_transcript_repr"], 16) == JAX_REF["toy"]["transcript_repr"]
    assert pathlib.Path(first["key_file"]).parent == tmp_path
    assert "start-up at k=6" in lines[0] and "proof 1 (cold)" in lines[0]
    assert "key reload (check)" in lines[0]
    # the plain versions ran: no kernel launched, so no launch counted
    assert first["kernel_launches"] and not any(first["kernel_launches"].values())
    json.dumps(first)  # the script writes it as JSON

    proved = []
    monkeypatch.setattr(prover, "create_proof",
                        lambda pk, *a, **kw: proved.append(pk) or bytes.fromhex(
                            first["proof_hex"]))
    second = run()
    assert (second["srs"], second["key"]) == ("in memory", "loaded")
    assert second["steps"][2]["skipped"] and not second["keygen_spans"]
    assert "load_s" in second["steps"][3] and "reload" not in second
    assert second["vk_transcript_repr"] == first["vk_transcript_repr"]
    assert second["steps"][-1]["ok"] and len(proved) == 2 and proved[0] is proved[1]

    # a key whose loaded proof differs fails the run
    outputs = iter([b"one", b"another"])
    monkeypatch.setattr(prover, "create_proof", lambda pk, *a, **kw: next(outputs))
    with pytest.raises(RuntimeError, match="differs"):
        run()


def _touch(path: pathlib.Path, size: int = 10) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"x" * size)
    return path


def test_gc_deletes_stale_and_orphaned_files_and_keeps_current_ones(tmp_path, monkeypatch,
                                                                    capsys):
    gc = _script("gc_torch_builds")
    from webauthn_halo2_tpu_torch.ops import kernels as KN
    from webauthn_halo2_tpu_torch.utils import host_build as HB

    monkeypatch.setattr(KN, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(HB, "BUILD_DIR", tmp_path / "host")
    current = [*KN.library_paths().values(), *HB.library_paths().values()]
    assert all(p.parent in (tmp_path / "kernels", tmp_path / "host") for p in current)
    keep = [_touch(p, 1000) for p in current]
    keep += [_touch(p.with_suffix(".log")) for p in KN.library_paths().values()]
    keep += [_touch(d / f".{name}.lock", 0) for d, names in (
        (tmp_path / "kernels", KN.SOURCES), (tmp_path / "host", HB.SOURCES)) for name in names]
    montmul = KN.library_paths()["montmul"]
    stale = [_touch(tmp_path / "kernels" / "libmontmul_0123456789abcdef.so"),
             _touch(tmp_path / "kernels" / "libmontmul_0123456789abcdef.log"),
             _touch(tmp_path / "kernels" / "libretired_fedcba9876543210.so"),
             _touch(tmp_path / "host" / "libpairing_0123456789abcdef.so")]
    orphaned = [_touch(montmul.with_suffix(".4242.tmp")),
                _touch(tmp_path / "host" / "libhashing_0123456789abcdef.77.88.tmp")]
    # a build of ntt holds its lock: its temporary file is live
    live = _touch(KN.library_paths()["ntt"].with_suffix(".99.tmp"))
    holder = open(tmp_path / "kernels" / ".ntt.lock", "a")
    fcntl.flock(holder, fcntl.LOCK_EX)
    try:
        gc.main(["--dry-run"])
        report = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert sorted(report["stale"]) == sorted(map(str, stale))
        assert sorted(report["orphaned"]) == sorted(map(str, orphaned))
        assert report["dry_run"]
        assert all(p.exists() for p in keep + stale + orphaned + [live])

        gc.main([])
        assert not any(p.exists() for p in stale + orphaned)
        assert all(p.exists() for p in keep + [live])
    finally:
        holder.close()


def test_gc_passes_over_a_file_gone_since_the_listing(tmp_path, monkeypatch, capsys):
    """A build renames its temporary file between the listing and the
    delete: the cleaner goes on and does not count it."""
    gc = _script("gc_torch_builds")
    gone = tmp_path / "libntt_0123456789abcdef.5.tmp"
    stale = _touch(tmp_path / "libntt_0123456789abcdef.so")
    monkeypatch.setattr(gc, "directories", lambda: ({}, []))
    monkeypatch.setattr(gc, "plan", lambda dirs: {"stale": [stale], "orphaned": [gone],
                                                  "kept": [gone]})
    assert gc.main([]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["stale"] == [str(stale)] and report["orphaned"] == []
    assert report["freed_bytes"] == 10 and report["kept_bytes"] == 0
    assert not stale.exists()
