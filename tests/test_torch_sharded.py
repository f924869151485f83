"""The port's multi-rank proving (parallel/sharded.py) on gloo ranks of the CPU.

One group of D = 2 and one of D = 4 spawned ranks (parallel/ranks.py),
each made once for the module: every rank runs every check and sends its
results back, and the tests below assert on them. The sharded transforms
must equal the port's single-device ones and an O(n^2) DFT on the host at
k = 9; the sharded MSM (n = 64, c = 4) and the batch commit (n = 32, B = 8)
the ref_curve host sums; every output the digests of the JAX package's
own sharded primitives on the same seeded inputs (its 8-device CPU mesh;
the `slow` test recomputes them live). The four ranks prove the K=6 toy
circuit with WH2_SHARDED=1, each with the JAX package's bytes, and
`ROUTES` shows every hooked call sharded. The routing rule: no group, or
a group of one, keeps one device; a transform with n % D^2 != 0 is not
sharded; NCCL with two ranks on one card raises before NCCL would. A rank
that raises fails the whole run with its traceback.
"""
import hashlib
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from webauthn_halo2_tpu_torch.fields.constants import BN254_FR, BN254_FR_GENERATOR
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE as G
from webauthn_halo2_tpu_torch.ops import ntt as N
from webauthn_halo2_tpu_torch.parallel import sharded as S
from webauthn_halo2_tpu_torch.parallel.ranks import run_ranks
from webauthn_halo2_tpu_torch.plonk.domain import Domain

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_prover import JAX_REF, _det_rng, toy_inputs  # noqa: E402

torch.set_num_threads(2)

R = BN254_FR
K_NTT, B_NTT = 9, 2  # sharded_ntt / sharded_intt: (8, 2, 2^9)
K_C2E, EXT_C2E = 7, 9  # sharded_coeff_to_extended: 2^7 -> 2^9
N_MSM, C_MSM = 64, 4
N_COMMIT, B_COMMIT = 32, 8

# sha256 of the JAX package's outputs on inputs(): its parallel/sharded.py
# on the 8-device CPU mesh of tests/conftest.py (`test_stored_jax_digests_are_current`)
JAX_DIGESTS = {
    "ntt": "8ac48613c5645dcc343084441fc166d549d5fe0ef01699f22ef55d3dd7c1a1b3",
    "intt": "ca819335fd1295545efa4629c48fd274c86f2e4c887abc4cf8447076eba57053",
    "c2e": "a2d2daeca7dbefc01880cc4a882c77fba7beb95b5af52a023b69194fc4015515",
    "msm": "0c014efb5cacffe10938a79b519920caba21609f41ef156f3866e331bd47d9c4",
    "commit": "36e522bddf7d06061dfe1ea4b9bbb969e3857fc9f08c5bd8f9eb3de076403fb5",
}


def _ints(seed: int, count: int) -> list:
    """`count` field elements of Fr from a numpy seed."""
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % R for w in words]


def inputs() -> dict:
    """Host ints of every check: columns, coefficients, MSM points as
    multiples s_i G (so that the host sum is one multiply) and scalars."""
    msm_s = _ints(3, N_MSM)
    com_s = _ints(5, N_COMMIT)
    return dict(
        ntt=[_ints(10 + b, 1 << K_NTT) for b in range(B_NTT)],
        c2e=[_ints(20 + b, 1 << K_C2E) for b in range(B_NTT)],
        msm_s=msm_s, msm_pts=[G.mul(s, G.g) for s in msm_s], msm_k=_ints(4, N_MSM),
        com_s=com_s, com_pts=[G.mul(s, G.g) for s in com_s],
        com_k=[_ints(30 + b, N_COMMIT) for b in range(B_COMMIT)])


def digest(vals) -> str:
    """sha256 of canonical ints (points as x, y; infinity as 0, 0)."""
    flat = []
    for v in vals:
        flat.extend((0, 0) if v is None else v if isinstance(v, tuple) else (v,))
    return hashlib.sha256(b"".join(int(v).to_bytes(32, "little") for v in flat)).hexdigest()


def _fr(cols: list) -> torch.Tensor:
    return torch.as_tensor(np.stack([FR_SPEC.encode(c) for c in cols], axis=1))


def _points(pts: list):
    from webauthn_halo2_tpu_torch.ops import ec as E

    return E.from_affine_ints(E.BN254_CURVE, pts)


def _proof_on_ranks() -> dict:
    """The K=6 toy circuit keyed and proved with the hooks on."""
    from webauthn_halo2_tpu_torch.plonk import cs as CS
    from webauthn_halo2_tpu_torch.plonk.keygen import keygen
    from webauthn_halo2_tpu_torch.plonk.prover import create_proof
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    os.environ["WH2_SHARDED"] = "1"
    for table in (S.ROUTES, S.COLLECTIVES):
        table.update((k, 0) for k in table)
    cs, fixed, advice, instances, copies = toy_inputs(CS)
    pk = keygen(get_srs(6, device="cpu"), cs, fixed, copies, device="cpu")
    proof = create_proof(pk, advice, instances, rng=_det_rng(JAX_REF["toy"]["seed"]),
                         device="cpu")
    return dict(proof=proof.hex(), routes=dict(S.ROUTES), collectives=dict(S.COLLECTIVES))


def _routing_rule(size: int) -> dict:
    """Which way the hooks go in this group: a transform too short to
    split (n % D^2 != 0) stays on one device; a group whose ranks claim one
    card refuses NCCL before NCCL would see it."""
    from webauthn_halo2_tpu_torch.plonk import fused

    os.environ["WH2_SHARDED"] = "1"
    S.ROUTES.update((k, 0) for k in S.ROUTES)
    k = 1 if size == 2 else 3  # n = 2 or 8: not a multiple of D^2
    x = _fr([_ints(40, 1 << k)])
    short = torch.equal(fused.batched_l2c(k, x), N.intt(FR_SPEC, x, k))
    routes = dict(S.ROUTES)
    get_backend, card_id = dist.get_backend, S._card_id
    dist.get_backend = lambda group=None: "nccl"
    S._card_id = lambda dev: "host/card-0"
    try:
        S.make_mesh(device="cuda:0")
        nccl = "no error"
    except RuntimeError as e:
        nccl = str(e)
    finally:
        dist.get_backend, S._card_id = get_backend, card_id
    return dict(short_equal=short, short_routes=routes, nccl=nccl)


def _rank_checks(rank: int, size: int, data: dict) -> dict:
    """Every check of one rank: the primitives' outputs as host ints, then
    (D = 4) the toy proof, and the routing rule."""
    torch.set_num_threads(1)
    os.environ["WH2_TRACE"] = "1"
    mesh = S.make_mesh(device="cpu")
    a = _fr(data["ntt"])
    out = dict(
        mesh=(mesh.rank, mesh.size, str(mesh.device), mesh.backend),
        ntt=FR_SPEC.decode(S.sharded_ntt(mesh, a, K_NTT).numpy()),
        intt=FR_SPEC.decode(S.sharded_intt(mesh, a, K_NTT).numpy()),
        c2e=FR_SPEC.decode(S.sharded_coeff_to_extended(
            mesh, _fr(data["c2e"]), K_C2E, EXT_C2E).numpy()),
        msm=S.sharded_msm(mesh, _points(data["msm_pts"]),
                          _fr([data["msm_k"]])[:, 0], C_MSM),
        commit=S.batch_commit(mesh, _points(data["com_pts"]), _fr(data["com_k"])))
    if size == 4:
        out["toy"] = _proof_on_ranks()
    out["rule"] = _routing_rule(size)
    return out


@pytest.fixture(scope="module")
def data():
    return inputs()


@pytest.fixture(scope="module")
def groups(data, tmp_path_factory):
    """{D: every rank's results} for a gloo group of D = 2 and of D = 4
    ranks on the CPU."""
    return {D: run_ranks(_rank_checks, D, str(tmp_path_factory.mktemp(f"rendezvous{D}")),
                         args=(data,), timeout=300)
            for D in (2, 4)}


@pytest.fixture(params=[2, 4])
def ranks(request, groups):
    """(D, every rank's results) of one group."""
    return request.param, groups[request.param]


def _host_dft(vals: list, w: int) -> list:
    n = len(vals)
    pw = [pow(w, e, R) for e in range(n)]
    return [sum(v * pw[i * j % n] for i, v in enumerate(vals)) % R for j in range(n)]


@pytest.fixture(scope="module")
def expected(data):
    """One device and the host on the same inputs."""
    w = N.root_of_unity(K_NTT)
    n_inv = pow(1 << K_NTT, R - 2, R)
    a = _fr(data["ntt"])
    c = _fr(data["c2e"])
    ext_w = N.root_of_unity(EXT_C2E)
    coset = []
    for col in data["c2e"]:
        shifted = [v * pow(BN254_FR_GENERATOR, i, R) % R for i, v in enumerate(col)]
        coset += _host_dft(shifted + [0] * ((1 << EXT_C2E) - len(col)), ext_w)
    msm = G.mul(sum(s * k for s, k in zip(data["msm_s"], data["msm_k"])) % R, G.g)
    commit = [G.mul(sum(s * k for s, k in zip(data["com_s"], ks)) % R, G.g)
              for ks in data["com_k"]]
    return dict(
        one_device=dict(
            ntt=FR_SPEC.decode(N.ntt(FR_SPEC, a, K_NTT).numpy()),
            intt=FR_SPEC.decode(N.intt(FR_SPEC, a, K_NTT).numpy()),
            c2e=FR_SPEC.decode(Domain(K_C2E, EXT_C2E).coeff_to_extended(c).numpy())),
        host=dict(
            ntt=sum((_host_dft(col, w) for col in data["ntt"]), []),
            intt=sum(([v * n_inv % R for v in _host_dft(col, pow(w, R - 2, R))]
                      for col in data["ntt"]), []),
            c2e=coset, msm=[msm], commit=commit))


def test_the_ranks_form_a_gloo_mesh_on_the_cpu(ranks):
    D, results = ranks
    assert [r["mesh"] for r in results] == [(r, D, "cpu", "gloo") for r in range(D)]


@pytest.mark.parametrize("what", ["ntt", "intt", "c2e"])
def test_sharded_transforms_equal_one_device_and_the_host_dft(ranks, expected, what):
    D, results = ranks
    for r in results:
        assert r[what] == expected["one_device"][what]
        assert r[what] == expected["host"][what]


def test_sharded_msm_and_batch_commit_equal_the_host_sums(ranks, expected):
    D, results = ranks
    for r in results:
        assert [r["msm"]] == expected["host"]["msm"]
        assert r["commit"] == expected["host"]["commit"]


def test_the_tree_of_complete_adds_keeps_the_odd_leftover_last():
    """Partial sums that cancel, that are equal, that are infinite: the
    complete add takes each, and an odd count keeps its last one."""
    from webauthn_halo2_tpu_torch.ops import ec as E

    P, Q = G.mul(7, G.g), G.mul(11, G.g)
    for parts, want in (([P, G.neg(P), Q], Q), ([P, P, P], G.mul(21, G.g)),
                        ([None, P], P), ([P, None, None, G.neg(P), Q], Q), ([None], None)):
        pts = _points(parts)
        got = S._tree_reduce_complete(E.JPoint(*(t[:, :, None] for t in pts)))
        assert E.to_affine_ints(E.BN254_CURVE, got) == [want]


@pytest.mark.parametrize("what", sorted(JAX_DIGESTS))
def test_outputs_equal_the_jax_package_digests(ranks, what):
    D, results = ranks
    for r in results:
        vals = [r["msm"]] if what == "msm" else r[what]
        assert digest(vals) == JAX_DIGESTS[what]


def test_toy_proof_on_four_ranks_equals_the_jax_bytes(groups):
    for r in groups[4]:
        toy = r["toy"]
        assert toy["proof"] == JAX_REF["toy"]["proof"]
        routes = toy["routes"]
        assert routes["commits_sharded"] and routes["l2c_sharded"] and routes["c2e_sharded"]
        assert not (routes["commits_one_device"] or routes["l2c_one_device"]
                    or routes["c2e_one_device"]), routes
        assert toy["collectives"]["calls"] and toy["collectives"]["bytes"]


def test_a_transform_too_short_to_split_stays_on_one_device(ranks):
    D, results = ranks
    for r in results:
        rule = r["rule"]
        assert rule["short_equal"]
        assert rule["short_routes"]["l2c_one_device"] == 1
        assert rule["short_routes"]["l2c_sharded"] == 0


def test_nccl_with_two_ranks_on_one_card_raises(ranks):
    D, results = ranks
    for r in results:
        assert "share host/card-0" in r["rule"]["nccl"], r["rule"]["nccl"]
        assert "gloo" in r["rule"]["nccl"]


def test_no_group_or_a_group_of_one_keeps_one_device(tmp_path, monkeypatch):
    from webauthn_halo2_tpu_torch.plonk import fused
    from webauthn_halo2_tpu_torch.plonk.keygen import commit_lagrange_batch
    from webauthn_halo2_tpu_torch.plonk.srs import get_srs

    monkeypatch.setenv("WH2_TRACE", "1")
    monkeypatch.setenv("WH2_SHARDED", "1")
    srs = get_srs(4, device="cpu")  # the committed k=4 SRS
    col = _fr([_ints(50, 16)])
    want = (commit_lagrange_batch(srs, col), N.intt(FR_SPEC, col, 4))

    def route_once():
        S.ROUTES.update((k, 0) for k in S.ROUTES)
        got = (commit_lagrange_batch(srs, col), fused.batched_l2c(4, col))
        assert got[0] == want[0] and torch.equal(got[1], want[1])
        return dict(S.ROUTES)

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        S.make_mesh(device="cpu")
    routes = route_once()
    assert routes["commits_one_device"] == 1 and routes["l2c_one_device"] == 1
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        routes = route_once()
        assert routes["commits_one_device"] == 1 and routes["l2c_one_device"] == 1
        assert not routes["commits_sharded"] and not routes["l2c_sharded"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                S.make_mesh()
        mesh = S.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        # the primitives themselves run at D = 1
        assert torch.equal(S.sharded_intt(mesh, col, 4), want[1])
    finally:
        dist.destroy_process_group()


def test_routes_are_counted_only_under_trace(monkeypatch):
    from webauthn_halo2_tpu_torch.plonk import fused

    monkeypatch.delenv("WH2_TRACE", raising=False)
    S.ROUTES.update((k, 0) for k in S.ROUTES)
    fused.batched_l2c(4, _fr([_ints(51, 16)]))
    assert not any(S.ROUTES.values())


def _fails_on_rank_one(rank: int, size: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails")
    time.sleep(120)  # rank 0 is ended when rank 1 fails
    return rank


def test_a_failing_rank_fails_the_run_with_its_traceback(tmp_path):
    t0 = time.time()
    with pytest.raises(Exception, match="rank one fails"):
        run_ranks(_fails_on_rank_one, 2, str(tmp_path), timeout=60)
    assert time.time() - t0 < 60


@pytest.mark.slow
def test_stored_jax_digests_are_current(data):
    """The JAX package's sharded primitives live on its 8-device CPU mesh,
    on inputs(), give JAX_DIGESTS."""
    import jax.numpy as jnp

    from webauthn_halo2_tpu.fields.limbs import FR_SPEC as JFR
    from webauthn_halo2_tpu.ops import ec as JE
    from webauthn_halo2_tpu.parallel import sharded as JS

    mesh = JS.make_mesh(8)

    def fr(col):
        return jnp.asarray(JFR.encode(col))

    def per_column(fn, cols):
        return sum((JFR.decode(np.asarray(fn(fr(col)))) for col in cols), [])

    live = dict(
        ntt=per_column(lambda a: JS.sharded_ntt(mesh, a, K_NTT), data["ntt"]),
        intt=per_column(lambda a: JS.sharded_intt(mesh, a, K_NTT), data["ntt"]),
        c2e=per_column(lambda a: JS.sharded_coeff_to_extended(mesh, a, K_C2E, EXT_C2E),
                       data["c2e"]),
        msm=JE.to_affine_ints(JE.BN254_CURVE, JS.sharded_msm(
            mesh, JE.from_affine_ints(JE.BN254_CURVE, data["msm_pts"]),
            fr(data["msm_k"]), c=C_MSM)),
        commit=JE.to_affine_ints(JE.BN254_CURVE, JS.batch_commit(
            mesh, JE.from_affine_ints(JE.BN254_CURVE, data["com_pts"]),
            jnp.stack([fr(ks) for ks in data["com_k"]]))))
    assert {k: digest(v) for k, v in live.items()} == JAX_DIGESTS
