"""The port stands alone, and its entry points default to the card.

An AST scan of every file of webauthn_halo2_tpu_torch/ (parallel/
included), of chip_smoke.py and of the port's scripts
(scripts/*_torch_*.py and scripts/*_torch.py): none imports jax or
anything of the JAX package, and no source of the port (.py, .cpp, .cu,
.cuh) names the JAX package's native libraries. Then each
public entry point, called without `device`, raises where there is no
CUDA device (only an explicit device="cpu" runs on the CPU).
"""
import ast
import pathlib

import pytest
import torch

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "webauthn_halo2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "webauthn_halo2_tpu")


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*_torch_*.py"))
            + sorted((ROOT / "scripts").glob("*_torch.py")))


def test_port_has_the_slice_modules():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for mod in ("fields/limbs.py", "ops/modops.py", "ops/ntt.py", "ops/poly.py",
                "ops/ec.py", "ops/msm.py", "ops/msm_fused.py", "ops/msm_v1.py",
                "ops/mxu_mod.py", "plonk/domain.py",
                "plonk/srs.py", "plonk/cs.py", "plonk/keygen.py", "plonk/fused.py",
                "plonk/prover.py", "plonk/verifier.py", "plonk/transcript.py",
                "utils/keccak.py", "fields/pairing.py", "circuits/ecdsa_circuit.py",
                "api.py", "convert.py", "evm/codegen.py", "evm/yul_asm.py",
                "evm/machine.py", "evm/yul_interp.py", "plonk/pk_cache.py",
                "plonk/mock.py", "circuits/sha256.py", "circuits/es256_circuit.py",
                "client/webauthn.py", "evm/yulc.py", "chain/abi.py", "chain/contracts.py",
                "server/bundler.py", "server/app.py", "utils/roofline.py",
                "utils/host_build.py", "fields/pairing_native.py",
                "parallel/__init__.py", "parallel/sharded.py", "parallel/ranks.py",
                "parallel/batch.py"):
        assert mod in names, mod
    assert {p.name for p in (PORT / "csrc").iterdir()} >= {
        "field.cuh", "ec.cuh", "montmul.cu", "ntt.cu", "msm.cu", "combine.cu", "ec.cu",
        "mxu.cu", "host"}
    assert {p.name for p in (PORT / "csrc" / "host").iterdir()} >= {"pairing.cpp", "hashing.cpp"}
    scripts = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"scripts/launch_multihost_torch.py", "scripts/sharded_torch_smoke.py",
            "scripts/deploy_suite_torch.py", "scripts/profile_torch_keygen.py",
            "scripts/gc_torch_builds.py"} <= scripts


def _port_sources():
    return sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cpp", ".cu", ".cuh"))


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_library_of_the_jax_package(path):
    """No source of the port names the JAX package's native directory (its
    libwh2pair.so, libwh2hash.so or their sources): the port builds and
    loads its own copies."""
    text = path.read_text()
    for bad in ("webauthn_halo2_tpu/native", "libwh2pair", "libwh2hash"):
        assert bad not in text, f"{path} names {bad}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    bad = {m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")


def test_get_srs_defaults_to_the_card():
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_srs(6)
    assert get_srs(6, device="cpu").g_lag.x.device.type == "cpu"


def test_keygen_and_create_proof_default_to_the_card():
    from webauthn_halo2_tpu_torch.plonk import cs as CS
    from webauthn_halo2_tpu_torch.plonk.keygen import keygen
    from webauthn_halo2_tpu_torch.plonk.prover import create_proof
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    _no_card()
    cs = CS.ConstraintSystem(num_fixed=1, num_advice=1)
    cs.gate("g", CS.fixed(0) * CS.advice(0))
    srs = get_srs(6, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        keygen(srs, cs, [[0] * 64], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        create_proof(object(), [[0]], [])


def test_mock_prove_defaults_to_the_card():
    from webauthn_halo2_tpu_torch.plonk import cs as CS
    from webauthn_halo2_tpu_torch.plonk.mock import mock_prove

    _no_card()
    cs = CS.ConstraintSystem(num_fixed=1, num_advice=1)
    cs.gate("g", CS.fixed(0) * CS.advice(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        mock_prove(cs, 4, [[1] * 16], [[0] * 8])
    assert mock_prove(cs, 4, [[1] * 16], [[0] * 8], device="cpu") == []


def test_api_defaults_to_the_card():
    from webauthn_halo2_tpu_torch import api

    _no_card()
    z = bytes(32)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof(z, z, z, z, z)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.verify(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.verify_evm(b"", scheme="shplonk")


def test_onchain_api_defaults_to_the_card(tmp_path):
    from webauthn_halo2_tpu_torch import api

    _no_card()
    z = bytes(32)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof_evm(z, z, z, z, z)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_verifier(sol_code_path=str(tmp_path / "v.sol"),
                              deploy_code_path=str(tmp_path / "v.code"),
                              yul_code_path=str(tmp_path / "v.yul"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.download_keys(17, str(tmp_path / "pk.json"), str(tmp_path / "vk.json"))
    assert not list(tmp_path.iterdir())


def test_serving_entry_points_default_to_the_card():
    from webauthn_halo2_tpu_torch import api
    from webauthn_halo2_tpu_torch.plonk.srs import generate_srs
    from webauthn_halo2_tpu_torch.server.bundler import World

    _no_card()
    z = list(bytes(32))
    req = dict(r=z, s=z, pubkey_x=z, pubkey_y=z, msghash=z)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proofs_batch([req])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_srs(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        World()


def test_chip_smoke_refuses_to_run_without_a_card():
    import subprocess
    import sys

    _no_card()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
