"""The port's on-chain half against the JAX package's, on the CPU.

Keys on disk (plonk/pk_cache.py), the Yul verifier codegen (evm/codegen.py),
its assembler (evm/yul_asm.py), the bytecode EVM (evm/machine.py) and the
Yul dry run (evm/yul_interp.py), at K=6 on the toy circuit of
tests/test_torch_prover.py and on the public-input circuit of
tests/test_evm_codegen.py (its permutation and copies included), copied
here. The JAX package's outputs under the deterministic `rng` of
test_torch_prover are stored here: the Yul text's sha256, the gas its
deployed verifier used on the JAX proof, and the public-input circuit's
GWC proof (the toy circuit's proofs are stored in test_torch_prover). The
`slow` test regenerates them live and has the JAX verifier and the JAX
package's EVM accept the port's proofs.
"""
import hashlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_torch_prover import CIRCUITS, JAX_REF, K, _det_rng  # noqa: E402

from webauthn_halo2_tpu_torch.evm.codegen import generate_verifier  # noqa: E402
from webauthn_halo2_tpu_torch.evm.machine import Chain  # noqa: E402
from webauthn_halo2_tpu_torch.evm.yul_asm import compile_yul  # noqa: E402
from webauthn_halo2_tpu_torch.evm.yul_interp import run_yul_verifier  # noqa: E402
from webauthn_halo2_tpu_torch.plonk import cs as CS  # noqa: E402
from webauthn_halo2_tpu_torch.plonk import pk_cache  # noqa: E402
from webauthn_halo2_tpu_torch.plonk.keygen import keygen  # noqa: E402
from webauthn_halo2_tpu_torch.plonk.prover import create_proof  # noqa: E402
from webauthn_halo2_tpu_torch.plonk.srs import get_srs  # noqa: E402
from webauthn_halo2_tpu_torch.plonk.transcript import KeccakRead, KeccakWrite  # noqa: E402
from webauthn_halo2_tpu_torch.plonk.verifier import verify_proof  # noqa: E402

torch.set_num_threads(2)

SENDER = 0xBEEF


def pubperm_inputs(cs_mod):
    """The public-input circuit of tests/test_evm_codegen.py:74-116: the
    advice cells copied to the instance cells."""
    cs = cs_mod.ConstraintSystem(num_fixed=1, num_advice=1, num_instance=1)
    cs.gate("pub", cs_mod.fixed(0) * (cs_mod.advice(0) - cs_mod.instance(0)))
    cs.enable_permutation(cs_mod.ADVICE, 0)
    cs.enable_permutation(cs_mod.INSTANCE, 0)
    n = 1 << K
    usable = cs.usable_rows(n)
    adv = [42, 99] + [0] * (usable - 2)
    qcol = [1, 1] + [0] * (n - 2)
    copies = [((cs_mod.ADVICE, 0, 0), (cs_mod.INSTANCE, 0, 0)),
              ((cs_mod.ADVICE, 0, 1), (cs_mod.INSTANCE, 0, 1))]
    return cs, [qcol], [adv], [[42, 99]], copies


# JAX package outputs, K=6: Yul sha256 and the gas of its deployed
# verifier on the JAX proof (made under _det_rng(name))
JAX_EVM = {
    "toy": dict(
        gwc=dict(yul_sha256="ea336ea7cca39ea40a33c57eccc93ba236570e481d6482f09112026d2585bf6c",
                 gas=371842),
        shplonk=dict(yul_sha256="1d814d2ebd6dd9ccbdbb528c6894eab8b2f8a46c5df5ef41b94053434a80d255",
                     gas=243825),
    ),
    "pubperm": dict(
        gwc=dict(
            yul_sha256="6c963512dd5fb36b0123dcdfce622f6be9e75800b442bd7cd2020033a72d406a",
            gas=259395,
            proof=(
            "1e21a5cba5ad3eb97f432571bf0c026253f0b7fb85f4aace5d34ed49e85a2320"
            "18b33d259e327ad3430da2f41754797f395b813d0d925112b5eee40284b4b155"
            "2f6c6fdfd3886e46c63fac42f30a06724a45de7b9060485f4456cb35afdd3662"
            "01ec385cfb62f37998c071cc7edf7283c02e081468672bed5e9767c25361415a"
            "0dbca1a38d923050935bee8649360f5c09b16e4a04ad88657c956d331c1c106f"
            "1c02cd35d273d6a32435741b191eee82f3a111924f3569ff7d9c481b9acd7b41"
            "277a1dbb95afe476a26cd9364732cd82c9897482c83471f9cc27c6c95729c88c"
            "21ae33d24130194ee688f591b1747072d1dd73801130d86f6b3ebc443b151ff0"
            "23880260aaf62914191c4915de9185f4ee0e479aedac9ac1c0d4dabc1d62ba98"
            "19a1811ca367eb6541810ab28e7edb4eb92b23298a2a16d9276d7e767f9b14ac"
            "1670005e84862407e5406ff32fc4f6fcc59aff7c6370c8dc3ba6bfafe080a007"
            "299f68f7a3abe04c349eda8b1f77d7bf7be4dc5272c36322d343d834d99f4fef"
            "1031ff18718e47950bbc21b7d4c94ba5bb99d94e677bbf5cc9ea7ddbed10670c"
            "298e1c74f7c4f8307664b79a287da2f8dd6610dc3bc6f21269640d718ecfff86"
            "0cb769bee16fe9b5d064284e0fe49d29982adaa4d4312a5f9ba522f12a88eb03"
            "18696e7c2a46af85ffde8ff616bff7175a77c55d8a45c138f10c9ea712366a53"
            "04b551e29230396f66464b25a454ec398b4142252aec97c36e74be17df077174"
            "14a1cf4ea259084d14e7ac0d7f5c134d9f58e65b0e76b92e5fef08578af2d691"
            "2395fff87f2760424a9c19b475adb8661d124659f9ff321ba9b30b4d7a266445"
            "2b901837af81983ee88778066ba10ebfa2478c9f804a3a1bfa1395971e7533da"
            "18d284fb056dbddf8bd0f12d5b1b95f70df9671b9dbbc9852ece080d4121c4df"
            "1833defcfc6259ac9ca127550436dd26ba451a22ca4a822b33d7843de7b4826e"
            "18af0970e220d9ec64d8aed880779cf933136c8640659ac162e07247171643f4"
            "141963b64d19f76882817cdec17b906ad06fa20e163fc9b94c4ed9d61c999189"
            ),
        ),
    ),
}


@pytest.fixture(scope="module")
def toy_keys(tmp_path_factory):
    """The toy pk made by keygen and saved, and the one loaded back."""
    tmp_dir = str(tmp_path_factory.mktemp("keys"))
    cs, fixed, _, _, copies = CIRCUITS["toy"](CS)
    srs = get_srs(K, device="cpu")
    made = pk_cache.keygen_cached(srs, cs, fixed, copies, tmp_dir, device="cpu")
    loaded = pk_cache.keygen_cached(srs, cs, fixed, copies, tmp_dir, device="cpu")
    return made, loaded


@pytest.fixture(scope="module")
def toy_proofs(toy_keys):
    """The toy circuit's GWC and SHPLONK proofs over Keccak, made with the
    loaded pk."""
    _, _, advice, instances, _ = CIRCUITS["toy"](CS)
    return {scheme: create_proof(toy_keys[1], advice, instances, rng=_det_rng(b"toy"),
                                 scheme=scheme, transcript=KeccakWrite(), device="cpu")
            for scheme in ("gwc", "shplonk")}


def _flip(proof: bytes) -> bytes:
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    return bytes(bad)


def _deploy(yul: str):
    deploy, runtime = compile_yul(yul)
    chain = Chain()
    addr, res = chain.create(SENDER, deploy)
    assert res.success, "verifier deployment failed"
    assert chain.account(addr).code == runtime
    return chain, addr


def test_pk_cache_round_trip(toy_keys, toy_proofs):
    """The loaded pk holds the saved tensors and vk, and proves the JAX
    package's GWC bytes."""
    made, loaded = toy_keys
    assert loaded is not made
    assert loaded.vk.transcript_repr == made.vk.transcript_repr == JAX_REF["toy"]["transcript_repr"]
    assert loaded.vk.fixed_commitments == made.vk.fixed_commitments
    assert loaded.vk.perm_commitments == made.vk.perm_commitments
    for name in ("fixed_ext", "sigma_ext", "l0_ext", "llast_ext", "lblind_ext", "x_ext",
                 "omega_mont"):
        assert torch.equal(getattr(loaded, name), getattr(made, name)), name
    for name in ("fixed_lagrange", "fixed_coeff", "sigma_lagrange", "sigma_coeff"):
        got, want = getattr(loaded, name), getattr(made, name)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)), name
    assert toy_proofs["gwc"].hex() == JAX_REF["toy"]["keccak"]["gwc"]


def test_pk_digest_changes_with_the_circuit():
    cs, fixed, _, _, copies = CIRCUITS["toy"](CS)
    base = pk_cache.pk_digest(K, cs, fixed, copies)
    assert base == pk_cache.pk_digest(K, cs, fixed, copies)
    assert base != pk_cache.pk_digest(K, cs, [fixed[0], fixed[1][:-1] + [1]], copies)
    assert base != pk_cache.pk_digest(K, cs, fixed, copies[:1])
    assert base != pk_cache.pk_digest(K, cs, fixed, copies, tau_seed=b"other")
    assert base != pk_cache.pk_digest(K + 1, cs, fixed, copies)
    cs2 = CIRCUITS["toy"](CS)[0]
    cs2.gate("extra", CS.fixed(0) * CS.advice(1))
    assert base != pk_cache.pk_digest(K, cs2, fixed, copies)


def test_load_pk_refuses_the_jax_format(tmp_path):
    """A file laid out as the JAX package's pk_cache writes it (33-limb
    arrays, no format tag) is refused."""
    cs, _, _, _, _ = CIRCUITS["toy"](CS)
    n = 1 << K
    path = tmp_path / "pk_k6_jax.npz"
    np.savez(path, fixed_lag_len=np.asarray([2]), fixed_lag_0=np.zeros((33, n), np.int32),
             l0_ext=np.zeros((33, 4 * n), np.int32),
             vk_repr=np.zeros(64, np.uint8))
    with pytest.raises(ValueError, match="format"):
        pk_cache.load_pk(str(path), get_srs(K, device="cpu"), cs, device="cpu")


@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
def test_toy_verifier_matches_jax_and_runs_in_the_evm(toy_keys, toy_proofs, scheme):
    """The toy vk's Yul equals the JAX package's text; deployed, it accepts
    the port's proof at the JAX verifier's gas and reverts on a flipped
    bit and on truncation; the Yul dry run gives the same verdicts."""
    pk = toy_keys[1]
    proof = toy_proofs[scheme]
    assert verify_proof(pk.vk, pk.srs, proof, [], scheme=scheme, transcript=KeccakRead(proof))
    yul, sol = generate_verifier(pk.vk, pk.srs, scheme=scheme)
    assert "plonk_verifier" in yul and "contract Verifier" in sol
    assert hashlib.sha256(yul.encode()).hexdigest() == JAX_EVM["toy"][scheme]["yul_sha256"]
    chain, addr = _deploy(yul)
    ok = chain.call(SENDER, addr, proof)
    assert ok.success, "the deployed verifier rejected the port's proof"
    assert ok.gas_used == JAX_EVM["toy"][scheme]["gas"]
    for bad in (_flip(proof), proof[:-32]):
        assert not chain.call(SENDER, addr, bad).success
    assert run_yul_verifier(yul, proof)
    assert not run_yul_verifier(yul, _flip(proof))
    assert not run_yul_verifier(yul, proof[:-32])


def test_public_inputs_bind_the_proof():
    """The public-input circuit: the port's GWC proof equals the JAX
    package's, its Yul equals the JAX text, and the deployed verifier
    accepts (public inputs, proof) at the JAX gas; wrong or missing public
    inputs revert, in the EVM and in the Yul dry run."""
    cs, fixed, advice, instances, copies = pubperm_inputs(CS)
    srs = get_srs(K, device="cpu")
    pk = keygen(srs, cs, fixed, copies, device="cpu")
    proof = create_proof(pk, advice, instances, rng=_det_rng(b"pubperm"), scheme="gwc",
                         transcript=KeccakWrite(), device="cpu")
    ref = JAX_EVM["pubperm"]["gwc"]
    assert proof.hex() == ref["proof"]
    pub = instances[0]
    assert verify_proof(pk.vk, srs, proof, [pub], scheme="gwc", transcript=KeccakRead(proof))
    yul, _sol = generate_verifier(pk.vk, srs, num_public=len(pub))
    assert hashlib.sha256(yul.encode()).hexdigest() == ref["yul_sha256"]
    chain, addr = _deploy(yul)

    def calldata(pubs, prf):
        return b"".join(v.to_bytes(32, "big") for v in pubs) + prf

    ok = chain.call(SENDER, addr, calldata(pub, proof))
    assert ok.success, "the verifier rejected a valid (public inputs, proof)"
    assert ok.gas_used == ref["gas"]
    for bad in (calldata([43, 99], proof), calldata([42, 98], proof), proof):
        assert not chain.call(SENDER, addr, bad).success
        assert not run_yul_verifier(yul, bad)
    assert run_yul_verifier(yul, calldata(pub, proof))


def _jax_evm_outputs(name: str, inputs):
    """Key, prove (GWC and SHPLONK over Keccak) and generate the verifiers
    with the JAX package: per scheme (proof, Yul, gas), plus its vk and SRS."""
    from webauthn_halo2_tpu.evm.codegen import generate_verifier as jgen
    from webauthn_halo2_tpu.evm.machine import Chain as JChain
    from webauthn_halo2_tpu.evm.yul_asm import compile_yul as jcompile
    from webauthn_halo2_tpu.plonk import cs as JCS
    from webauthn_halo2_tpu.plonk.keygen import keygen as jkeygen
    from webauthn_halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from webauthn_halo2_tpu.plonk.srs import get_srs as jget_srs
    from webauthn_halo2_tpu.plonk.transcript import KeccakWrite as JKeccakWrite

    cs, fixed, advice, instances, copies = inputs(JCS)
    srs = jget_srs(K)
    pk = jkeygen(srs, cs, fixed, copies)
    pub = instances[0] if instances else []
    out = {}
    for scheme in ("gwc", "shplonk"):
        proof = jcreate_proof(pk, advice, instances, rng=_det_rng(name.encode()),
                              scheme=scheme, transcript=JKeccakWrite())
        yul, _ = jgen(pk.vk, srs, num_public=len(pub), scheme=scheme)
        chain = JChain()
        addr, res = chain.create(SENDER, jcompile(yul)[0])
        assert res.success
        run = chain.call(SENDER, addr, b"".join(v.to_bytes(32, "big") for v in pub) + proof)
        out[scheme] = (proof, yul, run.gas_used if run.success else None, chain, addr)
    return out, pk.vk, srs, instances


@pytest.mark.slow
@pytest.mark.parametrize("name", ["toy", "pubperm"])
def test_stored_jax_evm_outputs_are_current(name, toy_proofs):
    """Regenerates JAX_EVM (and the toy Keccak proofs of JAX_REF) live, and
    has the JAX verifier and the JAX package's EVM accept the port's proofs
    (minutes: XLA:CPU compiles the JAX prover's graphs)."""
    from webauthn_halo2_tpu.plonk.transcript import KeccakRead as JKeccakRead
    from webauthn_halo2_tpu.plonk.verifier import verify_proof as jverify

    inputs = pubperm_inputs if name == "pubperm" else CIRCUITS["toy"]
    out, jvk, jsrs, instances = _jax_evm_outputs(name, inputs)
    pub = instances[0] if instances else []
    if name == "toy":
        port = toy_proofs
    else:
        cs, fixed, advice, _, copies = pubperm_inputs(CS)
        pk = keygen(get_srs(K, device="cpu"), cs, fixed, copies, device="cpu")
        port = {"gwc": create_proof(pk, advice, instances, rng=_det_rng(b"pubperm"),
                                    scheme="gwc", transcript=KeccakWrite(), device="cpu")}
    for scheme, proof in port.items():
        jproof, yul, gas, chain, addr = out[scheme]
        ref = JAX_EVM[name][scheme]
        assert hashlib.sha256(yul.encode()).hexdigest() == ref["yul_sha256"]
        assert gas == ref["gas"]
        assert jproof.hex() == (ref.get("proof") or JAX_REF[name]["keccak"][scheme])
        assert jverify(jvk, jsrs, proof, instances, scheme=scheme,
                       transcript=JKeccakRead(proof))
        calldata = b"".join(v.to_bytes(32, "big") for v in pub) + proof
        assert chain.call(SENDER, addr, calldata).success
