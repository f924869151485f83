"""The port's prover against the JAX package's, on the toy circuits (CPU).

The K=6 toy circuit of tests/test_plonk_e2e.py (a vertical gate, a range
lookup and copy constraints) and its public-input circuit, copied here.
The JAX package takes minutes on this CPU to key and prove them, so its
outputs under the deterministic `rng` below are stored here: the vk
transcript digest and the proof bytes. The port must reproduce both byte
for byte, on the default (v3) commit route, the serial one and the v1
one, and its verifier must accept the JAX proofs. The `slow` test
recomputes the stored values live from the JAX package and has the JAX
verifier accept the port's proofs.
"""
import functools
import hashlib

import pytest
import torch

from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk.keygen import keygen
from webauthn_halo2_tpu_torch.plonk.prover import create_proof
from webauthn_halo2_tpu_torch.plonk.srs import get_srs
from webauthn_halo2_tpu_torch.plonk.verifier import verify_proof

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

R = BN254_FR
K = 6

# JAX package outputs (keygen -> create_proof with _det_rng(seed)), K=6
JAX_REF = {
    "toy": dict(
        seed=b"toy",
        transcript_repr=0xcad7f5dae38b87f3d49e24c37034a979cd5beea8fd3347fb1ac4ae1688bf34b,
        proof=(
        "74c8b2d7a22bdf06a8072e601ad059a54f967aa5b20b585ba02c97038fab7c0f"
        "98c5231f6bc70f67169895d913d67ce3dd2940a66e0560086641b96bef1e7a03"
        "866dabf79cee45e620434eb5f0c01e0a0324044b6c7180287b561af57c5fc794"
        "0dcb50fc3f1a1344a88f1fedaaa4b0ce0dfe886d1788f842018146317be71d9d"
        "7e6c4433b886ed14cc80253d6b319b4793a4a3f115e3b9716ba13ca919f538a1"
        "618cfe041a69f8c41aa09d31d77f477dafdb13ddc07325ea9244f4f08d776d22"
        "fddb6badfb84cbca7a86e3939b806313e4b9a68580fefebc3909b7dc0074119e"
        "579f864d4b9529dd43abe8eb70a4791cdf628c20fb33066693faa1b95ce30719"
        "89b439707754ba5ff1798b2082084d3a60db4e8e73f3886f8031e81e8303ac99"
        "d3cc763383b6fab9eaf38aa6af19c573fdfd5a7a418c0436fac2de1d87972212"
        "09483725723953ae050d535604f008ee79c022956c2ffc70aea9361293f65f1f"
        "0d159ec64244c5c2241c2408f20a5cb47e4fa670b2264aa1897e938637abe025"
        "1bc8246b429e91bb5298a7105d04f65aac3681176ff8d0a16185c36718174d17"
        "2d02cd0bed0ac118ba1ab905d9144274bb26cbe28242cd0ff7c9d69eadaea601"
        "0909dece379d305278e6a4c882a391c83e94a865901e935a575be455fa2a5c01"
        "5dcbce70b444fba2fdd8dec3cbb719b9909dcaca201fbdfb9dbf94bcb157840b"
        "ed9f3fb36bb7cc7441b507e866ee0209c5616aea75676ebfc8b1ff829557ee05"
        "9ec73550de036e17fcbeaddedd1862a6e90f766e4c1a78d95681bea38580262f"
        "c314146d25bae6284d03b45d17f63a8b09615a84fae81a4d1859cf652c344200"
        "f8b2435992b5437ef7827428e877e9293675c4e01b60c9b6b6429686b335870f"
        "6c56c71ee4f664adf32e4cb7a7c907d587560ca1e311e4f0f33c58f68f11a60e"
        "3447b3fbe796454c4bb745f4dcbfdf6cac97a6d5081d2c85248be163e3dc7c1b"
        "79625503aff05db1445c5fcce6f6a019a312b02ac157508fb396f860fed4dd09"
        "6e529a07390349321107cc187bc74b3b8f80fa26e4ef734353fac50a97819f1f"
        "f040f814cac0e643aa4fc21562badf1f533e5a2aead7a6dbd850aab857c49d1b"
        "89eb10584a1128ef17989eaa8679725b773fdd0fb486bb5cc6a6c28e7335b00f"
        "b45d27e90fe89cc71039bbf21c432c00041fed278b3544c94381d4504cbb452c"
        "0dbf9296d5340f0ec71090b5c9d3b0841a8a187131732d1f97181f80793a3f0b"
        "64cce99602686a19eedc5c3f371809292650d07811eb08327d3499c68410031c"
    ),
    ),
    "pub": dict(
        seed=b"pub",
        transcript_repr=0x51414d552ad4fafea41251f3737d0701de16a6b35594fb04187a6675099c12f,
        proof=(
        "73f3f7c3eabf2adf01a5cf3c251f6a09e72a63cbf976cb5687c71f761df1678e"
        "f478ba6fe5b5e25ad5e31954e0fad0b0222c80d071ba8a4977a24d0ff1a41788"
        "e6dfa0465d57cd6cb8632d61389bd3f02c6f6c9fc6e6b734eea81ad5a00c7c89"
        "a90f44f24e8685b6d153a62445514165bb852261b7a74e5391dc48570322a728"
        "da54626b01bf88790b6a73510fce5a8c4fdffaa4a1a97362676267bcf74b101f"
        "23fcb2ca22310a1c8652fdbd4ed5bc8518ca445817ccd4869457ddf6c9259821"
        "f64e1eafb990b232dff927b626d7b2ac6933f0ce1c9548df1e032356f8ebb205"
        "5e3869d6f560b7655472d05584b9650f037b02e637ab3c8b19c80401b1725318"
        "5e3869d6f560b7655472d05584b9650f037b02e637ab3c8b19c80401b1725318"
    ),
    ),
}


def _det_rng(seed: bytes):
    """rng(nbytes) -> bytes: blake2b of the seed and a call counter."""
    ctr = [0]

    def rng(nbytes: int) -> bytes:
        ctr[0] += 1
        return hashlib.blake2b(seed + ctr[0].to_bytes(8, "little"),
                               digest_size=nbytes).digest()

    return rng


def build_toy(cs_mod):
    """fixed0 = q (gate selector), fixed1 = table; advice0 = gate column,
    advice1 = lookup input column (tests/test_plonk_e2e.py:24-37)."""
    cs = cs_mod.ConstraintSystem(num_fixed=2, num_advice=2)
    q = cs_mod.fixed(0)
    cs.gate("vgate", q * (cs_mod.advice(0, 0) + cs_mod.advice(0, 1) * cs_mod.advice(0, 2)
                          - cs_mod.advice(0, 3)))
    cs.lookup("range8", [cs_mod.advice(1)], [cs_mod.fixed(1)])
    cs.enable_permutation(cs_mod.ADVICE, 0)
    cs.enable_permutation(cs_mod.ADVICE, 1)
    return cs


def toy_inputs(cs_mod):
    """(cs, fixed, advice, instances, copies) of the toy circuit
    (tests/test_plonk_e2e.py:40-57)."""
    cs = build_toy(cs_mod)
    n = 1 << K
    usable = cs.usable_rows(n)
    a0, b0, c0 = 3, 5, 7
    d0 = (a0 + b0 * c0) % R
    b1, c1 = 2, 4
    d1 = (d0 + b1 * c1) % R
    adv0 = [a0, b0, c0, d0, d0, b1, c1, d1] + [0] * (usable - 8)
    adv1 = [1, 6, 5, 7, 0, 2] + [0] * (usable - 6)
    q = [1, 0, 0, 0, 1, 0, 0, 0] + [0] * (n - 8)
    table = [i for i in range(8)] + [0] * (n - 8)
    copies = [
        ((cs_mod.ADVICE, 0, 3), (cs_mod.ADVICE, 0, 4)),
        ((cs_mod.ADVICE, 0, 1), (cs_mod.ADVICE, 1, 2)),
    ]
    return cs, [q, table], [adv0, adv1], [], copies


def pub_inputs(cs_mod):
    """The public-input circuit of tests/test_plonk_e2e.py:127-150."""
    cs = cs_mod.ConstraintSystem(num_fixed=1, num_advice=1, num_instance=1)
    cs.gate("pub", cs_mod.fixed(0) * (cs_mod.advice(0) - cs_mod.instance(0)))
    n = 1 << K
    usable = cs.usable_rows(n)
    adv = [42, 99] + [0] * (usable - 2)
    qcol = [1, 1] + [0] * (n - 2)
    return cs, [qcol], [adv], [[42, 99]], []


CIRCUITS = {"toy": toy_inputs, "pub": pub_inputs}


@pytest.fixture(scope="module")
def srs():
    return get_srs(K, device="cpu")


@functools.lru_cache(maxsize=None)
def _keyed_and_proved(name: str):
    cs, fixed, advice, instances, copies = CIRCUITS[name](CS)
    pk = keygen(get_srs(K, device="cpu"), cs, fixed, copies, device="cpu")
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                         device="cpu")
    return name, pk, instances, proof


@pytest.fixture(scope="module", params=sorted(CIRCUITS))
def port_proof(request, srs):
    """(name, port pk, instances, port proof) per circuit, made once per
    process."""
    return _keyed_and_proved(request.param)


def test_vk_transcript_repr_matches_jax(port_proof):
    name, pk, _, _ = port_proof
    assert pk.vk.transcript_repr == JAX_REF[name]["transcript_repr"]


def test_proof_matches_jax_byte_for_byte(port_proof):
    name, _, _, proof = port_proof
    assert proof.hex() == JAX_REF[name]["proof"]


def test_port_verifier_accepts_jax_proof_and_rejects_tampering(port_proof, srs):
    name, pk, instances, _ = port_proof
    jax_proof = bytes.fromhex(JAX_REF[name]["proof"])
    assert verify_proof(pk.vk, srs, jax_proof, instances)
    bad = bytearray(jax_proof)
    bad[len(bad) // 2] ^= 1
    assert not verify_proof(pk.vk, srs, bytes(bad), instances)
    if instances:  # the proof is bound to its public inputs
        assert not verify_proof(pk.vk, srs, jax_proof, [[43, 99]])


@pytest.mark.parametrize("port_proof", ["toy"], indirect=True)
def test_serial_msm_route_gives_the_same_proof(port_proof, monkeypatch):
    """Committing through the serial Pippenger instead of the v3 pipeline
    gives the same commitments, so the same proof bytes."""
    from webauthn_halo2_tpu_torch.ops import msm as MS
    from webauthn_halo2_tpu_torch.plonk import keygen as KG

    name, pk, instances, _ = port_proof
    _, _, advice, _, _ = CIRCUITS[name](CS)
    monkeypatch.setattr(KG, "MSM_ENGINE", MS)
    calls = MS.CALLS["window_bucket_sum"]
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                         device="cpu")
    assert MS.CALLS["window_bucket_sum"] > calls
    assert proof.hex() == JAX_REF[name]["proof"]


@pytest.mark.parametrize("port_proof", ["pub"], indirect=True)
def test_v1_msm_route_gives_the_same_proof(port_proof, monkeypatch):
    """Committing through the v1 driver (one MSM at a time, the plain
    boundary scan of fused adds, the device Horner) gives the same
    commitments, so the same proof bytes. The public-input circuit keeps
    it cheap: each of its five MSMs folds about 250 doublings on the
    device."""
    from webauthn_halo2_tpu_torch.ops import msm_v1 as V
    from webauthn_halo2_tpu_torch.plonk import keygen as KG

    name, pk, instances, _ = port_proof
    _, _, advice, _, _ = CIRCUITS[name](CS)
    monkeypatch.setattr(KG, "MSM_ENGINE", V)
    calls = []
    monkeypatch.setattr(V, "horner", lambda *a, h=V.horner: calls.append(1) or h(*a))
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF[name]["seed"]),
                         device="cpu")
    assert len(calls) == 5
    assert proof.hex() == JAX_REF[name]["proof"]


def _jax_outputs(name: str):
    """Key and prove `name` with the JAX package: (transcript_repr, proof,
    JAX vk, JAX srs, instances)."""
    from webauthn_halo2_tpu.plonk import cs as JCS
    from webauthn_halo2_tpu.plonk.keygen import keygen as jkeygen
    from webauthn_halo2_tpu.plonk.prover import create_proof as jcreate_proof
    from webauthn_halo2_tpu.plonk.srs import get_srs as jget_srs

    cs, fixed, advice, instances, copies = CIRCUITS[name](JCS)
    srs_ = jget_srs(K)
    pk = jkeygen(srs_, cs, fixed, copies)
    proof = jcreate_proof(pk, advice, instances,
                          rng=_det_rng(JAX_REF[name]["seed"]))
    return pk.vk.transcript_repr, proof, pk.vk, srs_, instances


@pytest.mark.slow
def test_stored_jax_outputs_are_current(port_proof):
    """Regenerates JAX_REF live and has the JAX verifier accept the port's
    proof (minutes: XLA:CPU compiles the JAX prover's graphs)."""
    from webauthn_halo2_tpu.plonk.verifier import verify_proof as jverify

    name, _, instances, proof = port_proof
    repr_, jproof, jvk, jsrs, _ = _jax_outputs(name)
    assert repr_ == JAX_REF[name]["transcript_repr"]
    assert jproof.hex() == JAX_REF[name]["proof"]
    assert jverify(jvk, jsrs, proof, instances)
