"""Data-parallel proving (parallel/batch.py) on two gloo ranks of the CPU.

Two spawned ranks (parallel/ranks.py) key the K=6 toy circuit of
tests/test_torch_prover.py and prove their round-robin shares of four
copies of its witness, copy i with the deterministic rng of SEEDS[i].
Every index is proved exactly once; both ranks report the JAX package's
`transcript_repr` of the toy key; the copy proved with the seed b"toy"
gives the JAX package's stored proof byte for byte, and every other copy
the bytes of the same copy proved in one process by `api.prove_batch`
(proved here while the ranks run). A rank whose witness raises makes the
run raise within its timeout, naming that rank. `shard`, the rng and the
rank layout of the tcp rendezvous are checked without spawning. Last, a
valid P-256 signature whose witness the JAX package's circuit cannot
build is refused alike by the port's, and the launcher
(scripts/launch_multihost_torch.py) draws past it and lists it.
"""
import hashlib
import importlib.util
import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from webauthn_halo2_tpu_torch import api
from webauthn_halo2_tpu_torch.parallel import batch as B
from webauthn_halo2_tpu_torch.parallel import ranks as RK
from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks
from webauthn_halo2_tpu_torch.plonk import cs as CS
from webauthn_halo2_tpu_torch.plonk.keygen import keygen
from webauthn_halo2_tpu_torch.plonk.srs import get_srs

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_prover import JAX_REF, K, _det_rng, toy_inputs  # noqa: E402

torch.set_num_threads(2)

SEEDS = [b"batch0", JAX_REF["toy"]["seed"], b"batch2", b"batch3"]
RANKS = 2

# A valid ECDSA-P256 signature (key, message and nonce seeded from "0:1")
# whose witness neither package's circuit can build:
# an incomplete point addition (circuits/ecc.add_unequal) meets two points
# of one x in the fixed-base multiply
REJECTED = dict(
    r=0x576f2fd66da73b744b968c5644fbe84d3f25c13a9ac02f9d0b099a2f2479d6bb,
    s=0xe3f1e4ace5a1999bf8b1cdf293342512adbf6141477abe856f8cf15c41e51297,
    pubkey_x=0xad1a9c7d7f95e9bfdc8343fa095414b4f0c9fddbe5d27d5cd867577d3bac4d94,
    pubkey_y=0xd44ec4dbbfccb6bf290ea81c949c55db4ade38b8297e7026e8da4c6c808dba93,
    msghash=0x52a08056f000856031825b934e3fb3973bde9f8ea66fc7b68ae3c54dfb26e266,
)


def _toy_key():
    cs, fixed, advice, instances, copies = toy_inputs(CS)
    pk = keygen(get_srs(K, device="cpu"), cs, fixed, copies, device="cpu")
    return pk, (lambda: (advice, instances))


def _toy_rank(rank: int, size: int, bad_index: int | None = None) -> dict:
    """A rank: its card (here the CPU), the toy key, then its share of the
    four copies; the copy `bad_index` raises in its witness."""
    import os

    from webauthn_halo2_tpu_torch.parallel import sharded as S

    torch.set_num_threads(2)
    dev = S.make_mesh(device="cpu").device
    pk, witness = _toy_key()

    def failing():
        raise ValueError("this witness cannot be built")

    witnesses = [failing if i == bad_index else witness for i in range(len(SEEDS))]
    os.environ["WH2_SHARDED"] = "1"  # the sharded hooks' opt-in is refused
    try:
        B.prove_shard(pk, witnesses)
        refused = False
    except ValueError as e:
        refused = "WH2_SHARDED" in str(e)
    finally:
        del os.environ["WH2_SHARDED"]
    shard = B.prove_shard(pk, witnesses, [_det_rng(s) for s in SEEDS])
    return dict(device=str(dev), refused_sharded=refused, shard=shard)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and, proved in this process while they run,
    the one-process proofs of the copies whose seed is not b"toy"."""
    others = [i for i, s in enumerate(SEEDS) if s != JAX_REF["toy"]["seed"]]
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(run_ranks, _toy_rank, RANKS,
                            str(tmp_path_factory.mktemp("rendezvous")), timeout=300)
        pk, witness = _toy_key()
        alone = api.prove_batch(pk, [witness] * len(others),
                                rngs=[_det_rng(SEEDS[i]) for i in others])
        return ranks.result(), dict(zip(others, alone))


def test_every_index_is_proved_exactly_once(run):
    ranks, _ = run
    for r, out in enumerate(ranks):
        shard = out["shard"]
        assert (shard.rank, shard.size, out["device"]) == (r, RANKS, "cpu")
        assert sorted(shard.proofs) == B.shard(len(SEEDS), r, RANKS)
        assert [rec["indices"] for rec in shard.ranks] == [[0, 2], [1, 3]]
        assert sorted(shard.digests) == list(range(len(SEEDS)))
        assert all(not rec["invalid"] for rec in shard.ranks)


def test_both_ranks_hold_the_jax_toy_key(run):
    ranks, _ = run
    for out in ranks:
        assert {rec["vk"] for rec in out["shard"].ranks} == {JAX_REF["toy"]["transcript_repr"]}


def test_the_toy_seed_gives_the_jax_bytes(run):
    ranks, _ = run
    index = SEEDS.index(JAX_REF["toy"]["seed"])
    proof = ranks[index % RANKS]["shard"].proofs[index]
    assert proof.hex() == JAX_REF["toy"]["proof"]
    assert ranks[0]["shard"].digests[index] == hashlib.sha256(proof).hexdigest()


def test_every_other_index_equals_its_one_process_proof(run):
    ranks, alone = run
    proofs = {i: p for out in ranks for i, p in out["shard"].proofs.items()}
    for i, want in alone.items():
        assert proofs[i] == want, f"index {i}"
        for out in ranks:  # every rank holds every index's digest
            assert out["shard"].digests[i] == hashlib.sha256(want).hexdigest()


def test_the_sharded_hooks_opt_in_is_refused(run):
    ranks, _ = run
    assert all(out["refused_sharded"] for out in ranks)


def test_a_failing_rank_ends_the_run_within_its_timeout(tmp_path):
    timeout = 120
    t0 = time.time()
    with pytest.raises(Exception, match="rank 1 failed") as err:
        run_ranks(_toy_rank, RANKS, str(tmp_path), args=(1,), timeout=timeout)
    assert "this witness cannot be built" in str(err.value)
    assert time.time() - t0 < timeout


def test_shard_is_the_jax_round_robin():
    # launch_multihost.py: i % num_hosts == host_id
    for n in (0, 1, 5, 16):
        for size in (1, 2, 3, 4):
            shards = [B.shard(n, r, size) for r in range(size)]
            for r, mine in enumerate(shards):
                assert mine == [i for i in range(n) if i % size == r]
            assert sorted(i for s in shards for i in s) == list(range(n))
    with pytest.raises(ValueError):
        B.shard(4, 2, 2)


def test_seeded_rng_is_the_tests_deterministic_rng():
    a, b = B.seeded_rng(b"toy"), _det_rng(b"toy")
    assert [a(n) for n in (32, 64, 32)] == [b(n) for n in (32, 64, 32)]


def test_the_tcp_rendezvous_rank_arithmetic():
    assert RK.global_ranks(0, 1, 4) == ([0, 1, 2, 3], 4)
    assert RK.global_ranks(1, 2, 4) == ([4, 5, 6, 7], 8)
    assert RK.global_ranks(2, 3, 2) == ([4, 5], 6)
    layout = [r for h in range(3) for r in RK.global_ranks(h, 3, 2)[0]]
    assert layout == list(range(6))  # every global rank on exactly one host
    for bad in ((2, 2, 4), (-1, 2, 4), (0, 1, 0)):
        with pytest.raises(ValueError):
            RK.global_ranks(*bad)
    assert RK.init_method("/tmp/x", "10.0.0.1:29500") == "tcp://10.0.0.1:29500"
    assert RK.init_method("/tmp/x") == "file:///tmp/x/rendezvous"
    for bad in ("10.0.0.1", ":29500", "host:port"):
        with pytest.raises(ValueError):
            RK.init_method("/tmp/x", bad)


def _request(sig: dict) -> dict:
    return {name: list(v.to_bytes(32, "little")) for name, v in sig.items()}


def test_a_signature_the_jax_circuit_rejects_the_port_rejects_alike():
    from webauthn_halo2_tpu.circuits.ecdsa_circuit import CircuitParams as JaxParams
    from webauthn_halo2_tpu.circuits.ecdsa_circuit import ECDSACircuit as JaxCircuit
    from webauthn_halo2_tpu.circuits.ecdsa_circuit import ECDSAInputs as JaxInputs
    from webauthn_halo2_tpu_torch.fields.ref_curve import ecdsa_verify

    sig = REJECTED
    assert ecdsa_verify(sig["msghash"], sig["r"], sig["s"], (sig["pubkey_x"], sig["pubkey_y"]))
    with pytest.raises(ValueError, match="not invertible"):
        JaxCircuit(JaxParams()).witness(JaxInputs(
            r=sig["r"], s=sig["s"], msghash=sig["msghash"], pk=(sig["pubkey_x"], sig["pubkey_y"])))
    with pytest.raises(ValueError, match="not invertible"):
        api.request_witnesses([_request(sig)])[0]()


def test_the_launcher_draws_past_a_signature_the_circuit_rejects(monkeypatch):
    from webauthn_halo2_tpu_torch.circuits.ecdsa_circuit import CircuitParams

    spec = importlib.util.spec_from_file_location(
        "launch_multihost_torch", ROOT / "scripts" / "launch_multihost_torch.py")
    launcher = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, launcher)  # its dataclass looks itself up
    spec.loader.exec_module(launcher)
    drawn = launcher.signed_request
    monkeypatch.setattr(launcher, "signed_request",
                        lambda draw: _request(REJECTED) if draw == "7:0:0" else drawn(draw))
    requests, rejected = launcher.signed_requests(1, 7, CircuitParams())
    assert [(r["index"], r["attempt"]) for r in rejected] == [(0, 0)]
    assert requests == [drawn("7:0:1")]
