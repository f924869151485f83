"""The port's v3 MSM pipeline (ops/msm_fused.py) against the JAX package (CPU).

On the CPU every wrapper takes its plain version; csrc/msm.cu runs only on
the card, where chip_smoke.py holds each kernel against these plain
versions word for word.

  * The port's EC bodies (add_unsafe, which with Z2 = one is the mixed
    add; double; complete add) against the bodies of the JAX package's
    Pallas MSM kernels (msm_pallas._madd_body, _jadd_unsafe_body,
    _jdouble_body, _jadd_complete_body), run as plain jnp on the same SRS
    points, infinities, P == Q and P == -Q. Affine ints, exact.
  * Every commitment of plonk/keygen goes through its one engine.
  * The plain pipeline against the JAX package's stored MSM outputs and the
    host oracle of tests/test_torch_msm.py, on degenerate scalars, and at
    window sizes whose combine has m = 1, 2 and m > 2 buckets per chunk.
  * The plain pipeline on sparse scalars as the circuit's columns hold them
    (zeros with a few random tail rows, 0/1 selectors, 16-bit values, all
    ones) against the host oracle and the serial engine, with scan tiles
    narrow enough that segments cross several of them.
  * The plain interior leaves bucket 0 and every digit-0 fragment at
    infinity, and keeps the segment ids and everything else word-equal to
    the serial engine's `_lane_runs`.
  * The plain scan's segment totals equal the Hillis-Steele totals of
    `msm._prefix_scan_points` as points, on a row whose long segment spans
    every tile of the kernel's size.
  * The plain combine against the serial engine's suffix sums.
  * The kernels' library name changes when a shared header changes; the
    scan's tiling in Python is the kernel's.
The JAX Pallas kernels themselves take minutes per tiny MSM in interpret
mode, so they are held here through their bodies and the stored XLA MSM.
"""
import shutil

import numpy as np
import pytest
import torch

from test_torch_msm import JAX_MSM, _hex, _inputs, _oracle
from webauthn_halo2_tpu_torch import convert
from webauthn_halo2_tpu_torch.fields.constants import BN254_FR
from webauthn_halo2_tpu_torch.fields.limbs import FR_SPEC, W
from webauthn_halo2_tpu_torch.fields.ref_curve import BN254_G1_CURVE
from webauthn_halo2_tpu_torch.ops import ec as E
from webauthn_halo2_tpu_torch.ops import kernels as K
from webauthn_halo2_tpu_torch.ops import msm as MS
from webauthn_halo2_tpu_torch.ops import msm_fused as MF

# The suite runs several test processes on one host (pytest-xdist); torch's
# default of one thread per core then oversubscribes it, and the small
# int64 ops of the plain kernels run several times slower.
torch.set_num_threads(2)

CURVE = E.BN254_CURVE
G = BN254_G1_CURVE


def _srs_points(count: int) -> list:
    """The first `count` monomial SRS points [tau^i] G as host affine ints."""
    g, _ = _inputs(3 if count <= 8 else count.bit_length())
    return E.to_affine_ints(CURVE, convert.point_from_jax(*g, device="cpu"))[:count]


def _jax_affine(JE, xyz) -> list:
    return JE.to_affine_ints(JE.BN254_CURVE, JE.JPoint(*xyz))


def _port(pts: list) -> E.JPoint:
    return E.from_affine_ints(CURVE, pts)


def test_ec_bodies_match_jax_pallas_bodies():
    import jax.numpy as jnp

    from webauthn_halo2_tpu.fields.limbs import L
    from webauthn_halo2_tpu.ops import ec as JE
    from webauthn_halo2_tpu.ops import msm_pallas as MP

    fq = JE.BN254_CURVE.field
    p_col, one, pad, c256 = (jnp.asarray(np.asarray(v).reshape(L, 1), jnp.int32)
                             for v in (fq.p_limbs, fq.one_mont, fq.sub_pad,
                                       fq.c256_limbs))
    ps = _srs_points(8)
    neg2 = G.neg(ps[2])

    def both(pts):
        return JE.from_affine_ints(JE.BN254_CURVE, pts), _port(pts)

    # madd: a Jacobian sum (Z != 1) + distinct affine points
    a, c, aff = [ps[0], ps[1], ps[2]], [ps[3], ps[7], ps[6]], [ps[4], ps[5], ps[1]]
    (jA, pA), (jC, pC), (jB, pB) = both(a), both(c), both(aff)
    jx, jy, jz = MP._jadd_unsafe_body(fq, tuple(jA), tuple(jC), p_col, pad, c256)
    got_j = _jax_affine(JE, MP._madd_body(fq, jx, jy, jz, jB.x, jB.y,
                                          p_col, pad, c256, one))
    # the port's plain counterpart of the mixed add is add_unsafe with Z2 = one
    got_p = E.to_affine_ints(CURVE, E.add_unsafe(CURVE, E.add_unsafe(CURVE, pA, pC), pB))
    assert got_p == got_j == [G.add(G.add(x, y), z) for x, y, z in zip(a, c, aff)]

    # add_unsafe: distinct points and infinities on either side
    a = [ps[0], None, ps[2], None]
    b = [ps[1], ps[3], None, None]
    (jA, pA), (jB, pB) = both(a), both(b)
    got_j = _jax_affine(JE, MP._jadd_unsafe_body(fq, tuple(jA), tuple(jB),
                                                 p_col, pad, c256))
    got_p = E.to_affine_ints(CURVE, E.add_unsafe(CURVE, pA, pB))
    assert got_p == got_j == [G.add(x, y) for x, y in zip(a, b)]

    # double, infinity included
    a = [ps[0], ps[5], None]
    jA, pA = both(a)
    got_j = _jax_affine(JE, MP._jdouble_body(fq, tuple(jA), p_col, pad, c256))
    got_p = E.to_affine_ints(CURVE, E.double(CURVE, pA))
    assert got_p == got_j == [G.add(x, x) for x in a]

    # complete add: P + Q, P == Q, P == -Q, infinities
    a = [ps[0], ps[1], ps[2], None, ps[4], None]
    b = [ps[5], ps[1], neg2, ps[6], None, None]
    (jA, pA), (jB, pB) = both(a), both(b)
    got_j = _jax_affine(JE, MP._jadd_complete_body(fq, tuple(jA), tuple(jB),
                                                   p_col, pad, c256))
    got_p = E.to_affine_ints(CURVE, E.add(CURVE, pA, pB))
    assert got_p == got_j == [G.add(x, y) for x, y in zip(a, b)]


def test_every_commit_goes_through_the_one_engine(monkeypatch):
    """plonk/keygen's three commit functions all call `MSM_ENGINE`, which is
    the v3 pipeline unless a caller sets it to another engine."""
    from webauthn_halo2_tpu_torch.plonk import keygen as KG

    assert KG.MSM_ENGINE is MF
    seen = []

    class Engine:
        def msm_batch(self, curve, points, scalars):
            seen.append(("batch", points, scalars.shape))
            return ["batch"] * scalars.shape[1]

        def msm(self, curve, points, scalars):
            seen.append(("one", points, scalars.shape))
            return "one"

    monkeypatch.setattr(KG, "MSM_ENGINE", Engine())

    class Srs:
        g_lag, g_mono = "lagrange", "monomial"

    col = torch.zeros((W, 8), dtype=torch.int32)
    assert KG.commit_lagrange_batch(Srs, [col, col]) == ["batch"] * 2
    assert KG.commit_coeff_batch(Srs, torch.stack([col] * 3, dim=1)) == ["batch"] * 3
    assert KG.commit_coeff(Srs, col) == "one"
    assert KG.commit_lagrange_batch(Srs, []) == []
    assert seen == [("batch", "lagrange", (W, 2, 8)), ("batch", "monomial", (W, 3, 8)),
                    ("one", "monomial", (W, 8))]


@pytest.mark.parametrize("logn", [8, 10])
def test_msm_batch_matches_jax_and_oracle(logn):
    g, scalars = _inputs(logn)
    pts = convert.point_from_jax(*g, device="cpu")
    sc = torch.stack([torch.as_tensor(FR_SPEC.encode(ks)) for ks in scalars], dim=1)
    got = MF.msm_batch(CURVE, pts, sc)
    assert got == [_oracle(ks) for ks in scalars]
    assert _hex(got) == JAX_MSM[logn]


def _opening_digits(n: int, lanes: int) -> list:
    """Scalars whose window-0 digit 2j sits only at the first step of lane j."""
    S = n // lanes
    return [2 * (i // S) + (0 if i % S == 0 else 1) for i in range(n)]


@pytest.mark.parametrize("c, combine_g, m", [(4, 512, 1), (5, 16, 2), (6, 16, 4)])
def test_degenerate_scalars_and_combine_shapes(c, combine_g, m, monkeypatch):
    """One run spanning many lanes (all scalars equal), zeros, 0 / 1 / r-1,
    and digits whose only point opens a lane, as one batch; at window sizes
    whose combine has m = 1, 2 and 4 buckets per chunk (a narrower chunking
    than the card's G = 512 keeps m > 2 cheap here)."""
    monkeypatch.setattr(MF, "COMBINE_G", combine_g)
    n = 1 << 6
    g, _ = _inputs(6)
    pts = convert.point_from_jax(*g, device="cpu")
    cases = [[3] * n, [0] * n, [(0, 1, BN254_FR - 1)[i % 3] for i in range(n)],
             _opening_digits(n, MF.lanes_for(n))]
    assert MF._combine_shape(1 << c) == (min(combine_g, 1 << c), m)
    sc = torch.stack([torch.as_tensor(FR_SPEC.encode(ks)) for ks in cases], dim=1)
    assert MF.msm_batch(CURVE, pts, sc, c=c) == [_oracle(ks) for ks in cases]


def test_combine_plain_matches_serial_suffix_sums(monkeypatch):
    """sum_b b B_b by the (m, G) decomposition equals the serial engine's
    suffix sums and their total and the host sum, on buckets of distinct
    SRS points with empty (infinite) buckets between them, where suffix
    partials repeat."""
    monkeypatch.setattr(MF, "COMBINE_G", 16)
    nb = 64  # G = 16, m = 4
    g, _ = _inputs(7)
    ps = E.to_affine_ints(CURVE, convert.point_from_jax(*g, device="cpu"))
    rng = np.random.default_rng(7)
    rows = [[None if rng.random() < 0.4 else ps[r * nb + b] for b in range(nb)]
            for r in range(2)]
    rows[1][nb - 8:] = [None] * 8
    buckets = E.JPoint(*(t.reshape(W, 2, nb) for t in _port(rows[0] + rows[1])))
    got = E.to_affine_ints(CURVE, MF.combine_plain(CURVE, buckets))
    inf1 = E.infinity((2, 1), CURVE)
    zeroed = E.JPoint(*(torch.cat([i, b[..., 1:]], dim=-1)
                        for i, b in zip(inf1, buckets)))
    sfx = MS._suffix_sum_points(CURVE, zeroed)
    serial = E.to_affine_ints(CURVE, MS._sum_points(CURVE, MS._pt_cols(sfx, slice(1, nb))))
    host = []
    for row in rows:
        acc = None
        for b, p in enumerate(row):
            acc = G.add(acc, G.mul(b, p)) if p else acc
        host.append(acc)
    assert got == serial == host


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    g, scalars = _inputs(6)
    pts = convert.point_from_jax(*g, device="cpu")
    digits = MS.scalar_digits(torch.as_tensor(FR_SPEC.encode(scalars[0], mont=False)), 6)
    sdig, order = MF.sorted_stream(digits, MF.lanes_for(64))
    with pytest.raises(ValueError, match="CUDA"):
        MF.interior_cuda(CURVE, pts.x, pts.y, sdig, order, 64)
    buckets, bnd, seg = MF.interior(CURVE, pts.x, pts.y, sdig, order, 64)
    with pytest.raises(ValueError, match="CUDA"):
        MF.scan_cuda(CURVE, bnd, seg)
    with pytest.raises(ValueError, match="CUDA"):
        MF.combine_cuda(CURVE, buckets)
    assert MF.LAUNCHES == {"msm_interior": 0, "msm_scan": 0, "msm_combine": 0}


def test_sorted_stream_is_step_major_digit_order():
    rng = np.random.default_rng(3)
    digits = torch.as_tensor(rng.integers(0, 16, size=(3, 64)))
    sdig, order = MF.sorted_stream(digits, 4)  # K = 4 lanes, S = 16 steps
    assert sdig.shape == order.shape == (3, 16, 4)
    lane_major = order.transpose(1, 2).reshape(3, 64).to(torch.int64)
    ref_dig, ref_order = torch.sort(digits, dim=-1, stable=True)
    assert torch.equal(lane_major, ref_order)
    assert torch.equal(sdig.transpose(1, 2).reshape(3, 64).to(torch.int64), ref_dig)


def test_library_digest_covers_every_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(K.CSRC, csrc)
    monkeypatch.setattr(K, "CSRC", csrc)
    before = {name: K._so_path(name) for name in K.SOURCES}
    with open(csrc / "ec.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: K._so_path(name) for name in K.SOURCES}
    assert all(before[name] != after[name] for name in K.SOURCES)
    with open(csrc / "field.cuh", "a") as f:
        f.write("\n// edited\n")
    assert all(after[name] != K._so_path(name) for name in K.SOURCES)


def _sparse_cases(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def rnd():
        return int.from_bytes(rng.bytes(32), "little") % BN254_FR

    return {"zeros, 8 random tail rows": [0] * (n - 8) + [rnd() for _ in range(8)],
            "0/1 selectors": [int(v) for v in rng.integers(0, 2, n)],
            "16-bit values": [int(v) for v in rng.integers(0, 1 << 16, n)],
            "all ones": [1] * n}


@pytest.mark.parametrize("chunk, threads", [(2, 4), (4, 2)])
def test_sparse_scalars_match_oracle_and_serial(chunk, threads, monkeypatch):
    """The advice, selector and lookup columns of the circuit are mostly
    digit 0 with long runs of one digit. Scan tiles of 8 fragments (the
    32 fragments of a row cut into 4 tiles, two ways) make those runs
    cross every tile of a row."""
    monkeypatch.setattr(MF, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(MF, "SCAN_THREADS", threads)
    monkeypatch.setattr(MF, "SCAN_TILE", chunk * threads)
    n = 1 << 8
    g, _ = _inputs(8)
    pts = convert.point_from_jax(*g, device="cpu")
    cases = _sparse_cases(n, chunk)
    sc = torch.stack([torch.as_tensor(FR_SPEC.encode(ks)) for ks in cases.values()], dim=1)
    got = MF.msm_batch(CURVE, pts, sc)
    assert got == [_oracle(ks) for ks in cases.values()]
    assert got == MS.msm_batch(CURVE, pts, sc)


def test_interior_plain_skips_digit_zero():
    n, c = 1 << 8, 6
    g, scalars = _inputs(8)
    pts = convert.point_from_jax(*g, device="cpu")
    cols = [scalars[0], _sparse_cases(n, 3)["zeros, 8 random tail rows"]]
    digits = MS.scalar_digits(torch.stack(
        [torch.as_tensor(FR_SPEC.encode(ks, mont=False)) for ks in cols], dim=1), c)
    R = digits.shape[0] * 2
    lanes = MF.lanes_for(n)
    sdig, order = MF.sorted_stream(digits.reshape(R, n), lanes)
    buckets, bnd, seg = MF.interior_plain(CURVE, pts.x, pts.y, sdig, order, 1 << c)

    # the serial engine's run accumulation on the same stream, digit-0
    # points included
    one = E.infinity((R, lanes), CURVE).x
    idx = order.to(torch.int64)
    ref_b, ref_f, ref_seg = MS._lane_runs(
        CURVE, lambda t: (sdig[:, t], E.JPoint(pts.x[:, idx[:, t]], pts.y[:, idx[:, t]], one)),
        n // lanes, 1 << c, lambda acc, pt: E.add_unsafe(CURVE, acc, pt))
    assert torch.equal(seg, ref_seg)
    zero = seg == 0
    assert zero.any() and (~zero).any()
    inf = E.infinity((R, 2 * lanes), CURVE)
    for got, ref, i in zip(bnd, ref_f, inf):
        assert torch.equal(got[:, zero], i[:, zero])
        assert torch.equal(got[:, ~zero], ref[:, ~zero])
    assert not (ref_f.z[:, zero] != 0).sum() == 0  # the reference did add digit-0 points
    for got, ref in zip(buckets, ref_b):
        assert torch.equal(got[..., 1:], ref[..., 1:1 << c])
    assert torch.equal(buckets.z[..., 0], torch.zeros_like(buckets.z[..., 0]))


def test_scan_plain_totals_equal_hillis_steele_totals():
    """Row 0: digit 0, then digit 1 over more than two tiles of the
    kernel's 512 fragments (some of its fragments infinite, as a lane's
    first fragment is when the lane holds one run), then short segments.
    Row 1: short segments throughout. At every tail the plain scan gives
    the segment total of the serial engine's scan (infinity for digit 0)."""
    M = 3 * MF.SCAN_TILE
    g, _ = _inputs(12)
    frags = convert.point_from_jax(*g, device="cpu")
    rng = np.random.default_rng(12)
    row0 = [0] * 100 + [1] * (M - 300) + sorted(int(v) for v in rng.integers(2, 60, 200))
    row1 = sorted(int(v) for v in rng.integers(0, 900, M))
    seg = torch.tensor([row0, row1], dtype=torch.int32)
    z = frags.z[:, :2 * M].clone()
    z[:, rng.integers(0, 2 * M, 64)] = 0
    bnd = E.JPoint(frags.x[:, :2 * M].reshape(W, 2, M), frags.y[:, :2 * M].reshape(W, 2, M),
                   z.reshape(W, 2, M))
    tails = MS._tail_mask(seg)
    got = MF.scan_plain(CURVE, bnd, seg)
    ref = MS._prefix_scan_points(CURVE, bnd, seg)
    got_t = E.to_affine_ints(CURVE, E.JPoint(*(t[:, tails] for t in got)))
    ref_t = E.to_affine_ints(CURVE, E.JPoint(*(t[:, tails] for t in ref)))
    live = (seg[tails] != 0).tolist()
    assert [r if keep else None for r, keep in zip(ref_t, live)] == got_t
    assert sum(live) > 100 and not all(live)


def test_point_major_bases_hold_x_then_y():
    g, _ = _inputs(6)
    pts = convert.point_from_jax(*g, device="cpu")
    pm = MF.point_major(pts.x, pts.y)
    assert pm.shape == (64, 2 * W) and pm.is_contiguous() and pm.dtype == torch.int32
    assert torch.equal(pm[:, :W], pts.x.t()) and torch.equal(pm[:, W:], pts.y.t())


def test_combine_constants_are_the_kernels():
    src = (K.CSRC / "combine.cu").read_text()
    assert f"#define COMBINE_ROW_THREADS {MF.COMBINE_ROW_THREADS}\n" in src
    # stage 1 spreads a one-MSM batch (R = 20) over the card: 20 G threads
    G, m = MF._combine_shape(1 << 13)
    assert (G, m) == (MF.COMBINE_G, 8) and 20 * G >= 132 * 128
    assert MF._row_shape(G) == (256, 4)


def test_scan_tiling_is_the_kernels():
    src = (K.CSRC / "msm.cu").read_text()
    assert f"#define SCAN_THREADS {MF.SCAN_THREADS}\n" in src
    assert f"#define SCAN_CHUNK {MF.SCAN_CHUNK}\n" in src
    assert MF.SCAN_TILE == MF.SCAN_CHUNK * MF.SCAN_THREADS
    # a one-MSM batch at k = 17 (20 rows of 2 K = 4096 fragments) fills the
    # card's 132 SMs with scan blocks
    assert 20 * -(-2 * MF.lanes_for(1 << 17) // MF.SCAN_TILE) >= 132


def _host_combine(rows: list) -> list:
    """sum_b b B_b of each row of host affine buckets (None: empty)."""
    out = []
    for row in rows:
        acc = None
        for b, p in enumerate(row):
            acc = G.add(acc, G.mul(b, p)) if p else acc
        out.append(acc)
    return out


def _bucket_rows(rows: list) -> E.JPoint:
    nb = len(rows[0])
    return E.JPoint(*(t.reshape(W, len(rows), nb) for t in _port(sum(rows, []))))


@pytest.mark.parametrize("combine_g, row_threads", [(16, 4), (32, 2)])
def test_combine_row_spans_several_row_threads(combine_g, row_threads, monkeypatch):
    """A row's chunk partials spread over several stage-2 threads, each
    folding q > 1 of them, and its chunks over several stage-1 threads: the
    suffix of the thread totals and the three trees each carry a row's
    sum across threads. Mostly filled, mostly empty and empty rows."""
    monkeypatch.setattr(MF, "COMBINE_G", combine_g)
    monkeypatch.setattr(MF, "COMBINE_ROW_THREADS", row_threads)
    nb = 64
    G_, m = MF._combine_shape(nb)
    P, q = MF._row_shape(G_)
    assert (G_, m, P, q) == (combine_g, nb // combine_g, row_threads, combine_g // row_threads)
    ps = _srs_points(4 * nb)
    rng = np.random.default_rng(combine_g)
    rows = [[None if b == 0 or rng.random() < p else ps[r * nb + b] for b in range(nb)]
            for r, p in enumerate((0.2, 0.9, 1.0))]
    got = E.to_affine_ints(CURVE, MF.combine_plain(CURVE, _bucket_rows(rows)))
    assert got == _host_combine(rows)
    assert got[2] is None


def test_combine_one_bucket_and_empty_rows(monkeypatch):
    """A row with one non-empty bucket (its running and suffix sums repeat
    over every empty bucket below it), and a row with every bucket empty
    (the sum is infinity), on the card's row width."""
    monkeypatch.setattr(MF, "COMBINE_G", 32)
    nb = 256  # m = 8, P = 32, q = 1; and below, P = 8, q = 4
    ps = _srs_points(8)
    rows = [[None] * nb for _ in range(3)]
    rows[0][nb - 37] = ps[3]
    rows[2][1] = ps[5]
    want = [G.mul(nb - 37, ps[3]), None, ps[5]]
    buckets = _bucket_rows(rows)
    assert E.to_affine_ints(CURVE, MF.combine_plain(CURVE, buckets)) == want
    monkeypatch.setattr(MF, "COMBINE_ROW_THREADS", 8)
    assert E.to_affine_ints(CURVE, MF.combine_plain(CURVE, buckets)) == want


@pytest.mark.slow
def test_combine_plain_matches_jax_combine_interpret(monkeypatch):
    """The JAX package's Pallas `_combine` (interpret mode) and the plain
    combine on the same buckets (nb = 64 at G = 16, m = 4; the plain
    version's row reduction over 4 threads of 4 partials), as affine
    ints, and both against the host sum."""
    import jax.numpy as jnp

    from webauthn_halo2_tpu.fields.limbs import L
    from webauthn_halo2_tpu.ops import ec as JE
    from webauthn_halo2_tpu.ops import limbvec as V
    from webauthn_halo2_tpu.ops import msm_pallas as MP

    monkeypatch.setattr(MF, "COMBINE_G", 16)
    monkeypatch.setattr(MF, "COMBINE_ROW_THREADS", 4)
    nb, Gc = 64, 16
    m = nb // Gc
    ps = _srs_points(2 * nb)
    rng = np.random.default_rng(64)
    rows = [[None if b == 0 or rng.random() < p else ps[r * nb + b] for b in range(nb)]
            for r, p in enumerate((0.3, 0.8))]
    R = len(rows)
    jb = JE.from_affine_ints(JE.BN254_CURVE, sum(rows, []))

    def to_mg(c):  # (L, R nb) -> (R, m, PW, G) 16-bit packed, bucket g m + i
        b = jnp.transpose(c.reshape(L, R, nb), (1, 0, 2))
        b = jnp.concatenate([b[:, 0:L - 1:2] + (b[:, 1:L - 1:2] << 16), b[:, L - 1:]], axis=1)
        return jnp.transpose(b.reshape(R, V.PW, Gc, m), (0, 3, 1, 2))

    wx, wy, wz = MP._combine(JE.BN254_CURVE.field, to_mg(jb.x), to_mg(jb.y), to_mg(jb.z), True)
    got_j = JE.to_affine_ints(JE.BN254_CURVE,
                              JE.JPoint(*(jnp.transpose(c[:, :, 0]) for c in (wx, wy, wz))))
    got_p = E.to_affine_ints(CURVE, MF.combine_plain(CURVE, _bucket_rows(rows)))
    assert got_p == got_j == _host_combine(rows)
