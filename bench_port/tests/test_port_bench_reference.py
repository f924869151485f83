"""The plain reference against the port on the toy circuit (k = 6): the
layout digest and the constraint system's text, the verifying key worked
out again from tau, the witness check, and the verifier on the port's
proofs, a flipped one and a proof of a broken witness."""
import functools
import os

import pytest
import torch

from bp import plain, reference as ref
from toy_system import DUMMY, PARAMS, ToySystem


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    os.environ["WH2_KEY_DIR"] = str(tmp_path_factory.mktemp("keys"))
    system = ToySystem({})
    b = system._builder(True)
    system._synthesize(b, DUMMY)
    cs, fixed, advice, copies = b.finalize(PARAMS["degree"])
    pk = system.proving_key(torch.device("cpu"))
    circ = ref.Circuit(PARAMS["degree"], PARAMS["num_advice"], PARAMS["num_lookup_advice"],
                       PARAMS["lookup_bits"])
    tau = ref.derive_tau(b"dev")
    return system, cs, fixed, advice, copies, pk, circ, tau, ref.verifying_key(circ, fixed, copies, tau)


def test_the_circuit_text_and_layout_digest_equal_the_ports(toy):
    from webauthn_halo2_tpu_torch.plonk.pk_cache import synthesis_digest

    _s, cs, fixed, advice, copies, _pk, circ, _t, _vk = toy
    assert circ.gate_strings() == [(n, str(g)) for n, g in cs.gates]
    assert circ.lookup_strings() == [(lk.name, [str(e) for e in lk.inputs], [str(e) for e in lk.tables])
                                     for lk in cs.lookups]
    assert circ.perm_columns == cs.perm_columns and circ.degree == cs.degree()
    assert circ.usable == cs.usable_rows(circ.n)
    assert ref.layout_digest(circ, fixed, advice, copies) == synthesis_digest(cs, fixed, advice, copies)


def test_the_verifying_key_worked_out_again_equals_keygens(toy):
    system, _cs, fixed, _a, copies, pk, circ, tau, vk = toy
    assert ref.vk_mismatches(vk, *system.verifying_key(pk)) == 0
    other = [list(c) for c in fixed]
    other[0][3] ^= 1  # a selector moved
    assert ref.vk_mismatches(ref.verifying_key(circ, other, copies, tau), *system.verifying_key(pk)) >= 2


def test_the_witness_check(toy):
    system, _cs, fixed, _a, copies, _pk, circ, _t, _vk = toy
    req = plain.ecdsa_request(2 ** 40 + 3, "test", 0)
    assert plain.ecdsa_valid(req)
    adv, inst = system.witnesses([req])[0]()
    inputs = system.inputs()
    assert ref.witness_faults(circ, fixed, copies, adv, inst, inputs, req) == 0
    other = plain.ecdsa_request(2 ** 40 + 3, "test", 1)
    assert ref.witness_faults(circ, fixed, copies, adv, inst, inputs, other) > 0
    bad = [list(c) for c in adv]
    bad[0][0] += 1
    assert ref.witness_faults(circ, fixed, copies, bad, inst, inputs, req) >= 1
    assert ref.witness_faults(circ, fixed, copies, adv, [[1]], inputs, req) == 1


def test_the_verifier_on_the_ports_proofs(toy):
    from webauthn_halo2_tpu_torch.plonk.verifier import verify_proof

    system, _cs, _f, _a, _c, pk, _circ, tau, vk = toy
    req = plain.ecdsa_request(7, "test", 0)
    adv, inst = system.witnesses([req])[0]()
    bad = [list(c) for c in adv]
    bad[0][0] += 1
    good, broken = system.prove_batch(pk, [functools.partial(lambda a: a, (adv, inst)),
                                           functools.partial(lambda a: a, (bad, inst))])
    assert ref.verify(vk, good, tau) and verify_proof(pk.vk, pk.srs, good, [])
    flipped = good[:100] + bytes([good[100] ^ 1]) + good[101:]
    assert not ref.verify(vk, flipped, tau) and not verify_proof(pk.vk, pk.srs, flipped, [])
    assert not ref.verify(vk, broken, tau) and not verify_proof(pk.vk, pk.srs, broken, [])
    assert not ref.verify(vk, good + b"\0", tau)


def test_the_domain_is_where_the_ports_witness_exists():
    """bp/reference.in_domain against the program's ECDSA witness at k=17:
    a signature it puts outside the domain raises there, one inside does
    not; the set-up's warm-up signatures lie inside."""
    import json

    from bp.pool import WARM_UP
    from bp.system import EcdsaSystem

    assert all(ref.in_domain(plain.ecdsa_request(WARM_UP[1], WARM_UP[0], i)) for i in range(2))
    outside, inside = (plain.ecdsa_request(2 ** 33 + 24, "rank 0", i) for i in range(2))
    assert plain.ecdsa_valid(outside) and not ref.in_domain(outside)
    assert plain.ecdsa_valid(inside) and ref.in_domain(inside)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                           "ecdsa_p256_k17.json")) as f:
        system = EcdsaSystem(json.load(f)["circuit"])
    w_out, w_in = system.witnesses([outside, inside])
    with pytest.raises(ValueError):
        w_out()
    adv, _inst = w_in()
    assert len(adv) == 8
