"""The port's native host verification against its Python oracles (CPU).

The pairing check and G1 MSM of csrc/host/pairing.cpp and the Keccak of
csrc/host/hashing.cpp, built at first use into build/host/ (about 15 s for
the pairing library with g++ -O3), against fields/pairing.pairing_check_py,
plonk/verifier._host_msm_py and utils/keccak.keccak256_py; the K=6 proofs
of tests/test_torch_prover.py verify through the native path with the
verdicts of the Python one, the toy verifier runs in the port's EVM at
the JAX package's stored gas on either path, and a library that does not
build raises, with the compiler's output, and nothing falls back.
Modelled on tests/test_native_pairing.py. A Python pairing costs about
0.6 s here, so the oracle is called a few times only.
"""
import random
import subprocess
import sys
import textwrap

import pytest
import torch

from test_torch_evm import JAX_EVM, SENDER, _deploy, _flip
from test_torch_prover import JAX_REF, _keyed_and_proved
from webauthn_halo2_tpu_torch.evm import machine
from webauthn_halo2_tpu_torch.evm.codegen import generate_verifier
from webauthn_halo2_tpu_torch.fields import pairing as P
from webauthn_halo2_tpu_torch.fields import pairing_native as PN
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G
from webauthn_halo2_tpu_torch.plonk import verifier as V
from webauthn_halo2_tpu_torch.plonk.srs import get_srs
from webauthn_halo2_tpu_torch.plonk.transcript import KeccakRead
from webauthn_halo2_tpu_torch.utils import host_build as HB
from webauthn_halo2_tpu_torch.utils import keccak as KC

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def srs():
    return get_srs(6, device="cpu")


def test_pairing_check_true_and_false_against_the_oracle(srs):
    c = G.mul(987654321, G.g)
    true_pairs = [(c, srs.s_g2), (G.neg(c), srs.s_g2)]
    false_pairs = [(c, srs.s_g2), (G.neg(c), srs.g2)]
    assert P.pairing_check(true_pairs) is True
    assert P.pairing_check(false_pairs) is False
    assert P.pairing_check_py(true_pairs) is True
    assert P.pairing_check_py(false_pairs) is False
    rng = random.Random(7)
    p1, p2 = (G.mul(rng.randrange(1, 2**60), G.g) for _ in range(2))
    mixed = [(p1, srs.g2), (p2, srs.s_g2)]
    assert P.pairing_check(mixed) == P.pairing_check_py(mixed)
    # infinity entries are skipped; no pair at all is the empty product
    five = G.mul(5, G.g)
    assert P.pairing_check([(None, srs.g2), (five, srs.g2), (G.neg(five), srs.g2)]) is True
    assert P.pairing_check([]) is True


def test_g1_msm_against_the_oracle_with_infinity_and_zero_scalars():
    rng = random.Random(11)
    pts = [G.mul(rng.randrange(1, 2**40), G.g) for _ in range(37)]
    sc = [rng.randrange(0, G.n) for _ in range(37)]
    pairs = list(zip(pts, sc))
    pairs[3] = (None, 12345)
    pairs[9] = (pts[9], 0)
    pairs[20] = (pts[20], G.n)  # a scalar of r is zero too
    assert V._host_msm(pairs) == V._host_msm_py(pairs)
    p = G.mul(42, G.g)
    assert V._host_msm([]) is None
    assert V._host_msm([(None, 5), (p, 0)]) is None
    assert V._host_msm([(p, 1)]) == p
    assert V._host_msm([(p, G.n - 1), (p, 1)]) is None
    assert V._host_msm([(p, -1)]) == G.neg(p) == V._host_msm_py([(p, -1)])


def test_keccak_against_the_oracle_across_the_rate():
    rng = random.Random(3)
    for length in range(301):  # 0-300 bytes: the 136-byte rate crossed twice
        data = bytes(rng.getrandbits(8) for _ in range(length))
        assert KC.keccak256(data) == KC.keccak256_py(data), length
    assert KC.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert KC.keccak256(bytearray(b"abc")) == KC.keccak256_py(b"abc")


def _python_path(monkeypatch):
    monkeypatch.setattr(V, "pairing_check", P.pairing_check_py)
    monkeypatch.setattr(V, "_host_msm", V._host_msm_py)


@pytest.mark.parametrize("scheme", ["shplonk", "gwc"])
def test_k6_proofs_verify_natively_with_the_python_verdicts(scheme, srs, monkeypatch):
    """The stored JAX toy proofs (SHPLONK over Blake2b, GWC over Keccak)
    verify, and a flipped copy fails, on the native path and the Python one."""
    _, pk, instances, _ = _keyed_and_proved("toy")
    proof = bytes.fromhex(JAX_REF["toy"]["proof"] if scheme == "shplonk"
                          else JAX_REF["toy"]["keccak"]["gwc"])

    def verify(data):
        if scheme == "shplonk":
            return V.verify_proof(pk.vk, srs, data, instances)
        return V.verify_proof(pk.vk, srs, data, instances, scheme="gwc",
                              transcript=KeccakRead(data))

    native = (verify(proof), verify(_flip(proof)))
    _python_path(monkeypatch)
    assert native == (True, False) == (verify(proof), verify(_flip(proof)))


def test_toy_verifier_gas_equals_the_stored_value_on_both_paths(monkeypatch):
    """The toy vk's SHPLONK verifier in the port's EVM: the JAX proof runs
    at the stored gas and a flipped copy reverts, with the native pairing
    and Keccak and with the Python ones."""
    _, pk, _, _ = _keyed_and_proved("toy")
    proof = bytes.fromhex(JAX_REF["toy"]["keccak"]["shplonk"])
    yul, _ = generate_verifier(pk.vk, pk.srs, scheme="shplonk")

    def run():
        chain, addr = _deploy(yul)
        ok = chain.call(SENDER, addr, proof)
        return ok.success, ok.gas_used, chain.call(SENDER, addr, _flip(proof)).success

    want = (True, JAX_EVM["toy"]["shplonk"]["gas"], False)
    assert run() == want
    monkeypatch.setattr(machine, "pairing_check", P.pairing_check_py)
    monkeypatch.setattr(machine, "keccak256", KC.keccak256_py)
    assert run() == want


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch, srs):
    """With a compiler that fails (a missing forced include), every native
    entry raises RuntimeError with the compiler's output, the verifier too,
    and no library is left behind."""
    monkeypatch.setattr(HB, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(HB, "_LIBS", {})
    monkeypatch.setattr(HB, "CXX_FLAGS", HB.CXX_FLAGS + ["-include", "wh2_no_such_header.h"])
    with pytest.raises(RuntimeError, match="wh2_no_such_header.h"):
        KC.keccak256(b"abc")
    with pytest.raises(RuntimeError, match="host library pairing failed to build"):
        P.pairing_check([(G.g, srs.g2)])
    with pytest.raises(RuntimeError, match="host library pairing failed to build"):
        PN.g1_msm([(G.g, 2)])
    _, pk, instances, _ = _keyed_and_proved("toy")
    with pytest.raises(RuntimeError, match="failed to build"):
        V.verify_proof(pk.vk, srs, bytes.fromhex(JAX_REF["toy"]["proof"]), instances)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    assert HB._LIBS == {}


def test_processes_building_at_once_compile_once(tmp_path):
    """Three processes ask for the Keccak library in a new build directory
    at once, through a compiler that logs each compile: one compiles under
    the file lock, the others load its file."""
    log = tmp_path / "compiles.log"
    cxx = tmp_path / "cxx.sh"
    cxx.write_text(f'#!/bin/sh\ncase " $* " in *" -o "*) echo compile >> {log};; esac\n'
                   f'exec {HB.CXX} "$@"\n')
    cxx.chmod(0o755)
    build = tmp_path / "build"
    script = textwrap.dedent(f"""
        import ctypes, importlib.util, pathlib
        spec = importlib.util.spec_from_file_location("hb", {str(HB.__file__)!r})
        hb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(hb)
        hb.BUILD_DIR = pathlib.Path({str(build)!r})
        hb.CXX = {str(cxx)!r}
        out = ctypes.create_string_buffer(32)
        hb.load("hashing").wh2_keccak256(b"", 0, out)
        print(out.raw.hex(), hb.so_path("hashing").name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    digest, name = lines.pop().split()
    assert digest == KC.keccak256_py(b"").hex()
    assert log.read_text().splitlines() == ["compile"]
    assert [p.name for p in build.glob("*.so")] == [name]
    assert not list(build.glob("*.tmp"))


def test_threads_verify_at_once_in_a_fresh_process(srs):
    """ctypes releases the GIL, so a server's threads enter the pairing
    library together: eight threads make a fresh process's first native
    calls at once (the Frobenius tables are filled by the first of them)
    and every verdict is right."""
    c = G.mul(987654321, G.g)
    true_pairs = [(c, srs.s_g2), (G.neg(c), srs.s_g2)]
    false_pairs = [(c, srs.s_g2), (G.neg(c), srs.g2)]
    PN.pairing_check(true_pairs)  # the library is built before the threads start
    script = textwrap.dedent(f"""
        import threading
        from webauthn_halo2_tpu_torch.fields import pairing_native as PN
        from webauthn_halo2_tpu_torch.utils import host_build
        host_build.load("pairing")
        cases = [({true_pairs!r}, True), ({false_pairs!r}, False)]
        start = threading.Barrier(8)
        wrong = []

        def run(i):
            start.wait()
            for j in range(4):
                pairs, want = cases[(i + j) % 2]
                if PN.pairing_check(pairs) is not want:
                    wrong.append((i, j))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print("wrong", wrong)
    """)
    root = HB.SRC_DIR.parent.parent.parent
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "wrong []"
