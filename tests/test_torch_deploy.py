"""The port's deploy step against the JAX package's (CPU).

scripts/deploy_suite_torch.py and the JAX package's scripts/deploy_suite.py
run as subprocesses: with the stub verifier, and with the production k=17
verifier (results/P256Verifier.yul compiled by the port's assembler into a
{"code": [...]} file) and the JAX package's k=17 GWC proof. Every report row
and its gas are equal. With one byte of the proof flipped, both exit
nonzero, and the port's script names handleOps and its revert data.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from webauthn_halo2_tpu_torch.evm.yul_asm import compile_yul

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = {"port": ROOT / "scripts" / "deploy_suite_torch.py",
           "jax": ROOT / "scripts" / "deploy_suite.py"}
ROW = re.compile(r"^  (?P<name>.+?)\s+(?P<gas>[0-9,]+)$")


def _run(script: str, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(SCRIPTS[script]), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _report(out: str) -> list:
    return [(m["name"], int(m["gas"].replace(",", "")))
            for m in map(ROW.match, out.splitlines()) if m]


@pytest.fixture(scope="module")
def production(tmp_path_factory) -> tuple:
    """(the production verifier's .code file, the k=17 GWC proof's hex file,
    a copy with one byte flipped)."""
    tmp = tmp_path_factory.mktemp("deploy")
    deploy, _ = compile_yul((ROOT / "results" / "P256Verifier.yul").read_text())
    code = tmp / "P256Verifier.code"
    code.write_text(json.dumps({"code": list(deploy)}))
    proof = bytearray.fromhex((ROOT / "results" / "proof_gwc_k17.hex").read_text().strip())
    proof[len(proof) // 2] ^= 1
    flipped = tmp / "flipped.hex"
    flipped.write_text(proof.hex())
    return str(code), str(ROOT / "results" / "proof_gwc_k17.hex"), str(flipped)


@pytest.mark.parametrize("verifier", ["stub", "k17"])
def test_the_gas_report_equals_the_jax_scripts(verifier, production):
    args = [] if verifier == "stub" else ["--verifier-code", production[0],
                                          "--proof", production[1]]
    runs = {name: _run(name, *args) for name in SCRIPTS}
    for name, run in runs.items():
        assert run.returncode == 0, f"{name}: {run.stderr[-2000:]}"
        assert "counter incremented through handleOps: OK" in run.stdout
    port, jax = (_report(runs[name].stdout) for name in ("port", "jax"))
    assert port == jax and len(port) == 9
    assert port[0][0] == ("deploy Verifier (stub)" if verifier == "stub"
                          else "deploy Verifier (generated)")
    assert port[-1][0] == "handleOps (1 op, e2e)"
    assert runs["port"].stdout == runs["jax"].stdout


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_a_flipped_proof_fails_the_deploy(script, production):
    run = _run(script, "--verifier-code", production[0], "--proof", production[2])
    assert run.returncode != 0
    assert "handleOps" in run.stderr
    if script == "port":
        assert re.search(r"handleOps failed \(gas [0-9,]+\): revert data 0x[0-9a-f]+",
                         run.stderr)
        assert "counter incremented" not in run.stdout


def test_the_options_go_together(production):
    run = _run("port", "--verifier-code", production[0])
    assert run.returncode == 2 and "go together" in run.stderr
