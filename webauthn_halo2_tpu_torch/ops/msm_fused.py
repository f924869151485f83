"""The v3 Pippenger commit pipeline over bn254 G1: the prover's MSM engine.

The port of the JAX package's ops/msm_pallas.py (`_msm_windows_v3` and
`msm_hostout`, its default commit path on the TPU). B MSMs over one
affine base set run as R = Wn * B rows, row r = w * B + b being window w
of MSM b:

  1. scalars -> canonical words -> c-bit digits (`msm.scalar_digits`);
  2. per row, one sort of the keys (digit << log n) | index, laid out
     step-major (R, S, K): lane k of a row walks sorted positions
     [k S, (k + 1) S), and step t of every lane is contiguous;
  3. the interior kernel: one mixed add per step into each lane's run;
     closed interior runs go straight into buckets[row, digit], each lane's
     first run and final accumulator into the boundary fragments
     [A_0, B_0, A_1, B_1, ...] with their digits;
  4. the scan kernels: a segmented reduction of the 2K fragments, each
     segment's total at its last fragment (its tail);
  5. the scatter of each segment's tail into its bucket;
  6. the combine kernels: sum_b b * B_b per row, a chunk pass over G
     chunks of m buckets, then a reduction of the chunk partials per row
     (csrc/combine.cu; bounded by operations, and where a batch has few
     rows by the latency of the row reduction's chain of dependent adds,
     which the design keeps to about 25 adds);
  7. the (R,) window sums to the host, and the Horner fold on host ints.

The window sums are the JAX pipeline's points; their Jacobian words may
differ. What steps 3, 4 and 6 return differs in three ways:
  * Points whose digit is 0 contribute nothing: bucket 0, and every
    fragment labelled with digit 0, hold infinity. The combine gives
    bucket 0 no weight (as the JAX `_combine_kernel` does): B_0 enters only
    chunk 0's total T_0, T_0 only the first row thread's total and its
    suffix E_0, which the window sum leaves out, and each weighted sum adds
    run_i for i >= 1 only. The segment ids are the JAX ids, and every
    digit != 0 gets the same adds in the same order, so its buckets and
    fragments are the same words.
  * The scan returns segment totals, not an inclusive scan: at the tail of
    each segment with a nonzero digit its total, at a digit-0 tail
    infinity; other positions are unspecified, and `scatter_tails` reads
    none of them. The adds associate otherwise than the serial engine's
    Hillis-Steele scan, so a total may be another Jacobian representative
    of the same point.
  * The combine spreads a row over the card in two stages (a chunk pass,
    then a reduction of the chunk partials per row; `combine_plain`), so
    it associates the adds otherwise than the JAX kernel's single (m, G)
    pass, and a window sum may be another representative of the same
    point.

Each kernel's wrapper sits beside its plain PyTorch version of the same
function, word for word, and counts its launches in `LAUNCHES`. The
wrappers take the plain version only for a CPU tensor; for a CUDA tensor
they launch csrc/msm.cu (interior, scan) and csrc/combine.cu or raise.

PRECONDITION (as in the JAX package): the base points are affine
(Z = one) and pairwise distinct, as SRS bases are; runs and fragments are
sums of disjoint subsets, so they use adds that do not handle P == +-Q.
"""
from __future__ import annotations

import torch

from ..fields.limbs import FR_SPEC, W
from . import ec as E
from . import kernels as K
from . import modops as M
from . import msm as MS
from .ec import CurveSpec, JPoint

DEFAULT_K_LANES = 2048
# the combine's chunking (csrc/combine.cu): G chunks of nb / G buckets a row,
# one stage-1 thread each; a row's stage-2 block has COMBINE_ROW_THREADS
# threads (the kernel's most). Chosen by measurement on a proof's commit
# batches (scripts/sweep_torch_kernels.py).
COMBINE_G = 1024
COMBINE_ROW_THREADS = 256
# the scan's tiling (csrc/msm.cu SCAN_CHUNK, SCAN_THREADS): a tile of
# SCAN_TILE fragments a block
SCAN_CHUNK = 4
SCAN_THREADS = 128
SCAN_TILE = SCAN_CHUNK * SCAN_THREADS

LAUNCHES = {"msm_interior": 0, "msm_scan": 0, "msm_combine": 0}


def lanes_for(n: int) -> int:
    """K: at most DEFAULT_K_LANES, at least 16 steps a lane where n
    allows, K | n. At n = 2^17 that is the JAX package's K = 2048 (S = 64);
    at small n it keeps the scan of the 2K fragments short."""
    k = max(1, min(DEFAULT_K_LANES, n // 16))
    while n % k:
        k //= 2
    return k


def sorted_stream(digits: torch.Tensor, lanes: int):
    """(R, n) digits -> (sdig, order), each (R, S, K) int32 step-major.

    One sort of (digit << log n) | index per row: the digit order, ties by
    point index, as the JAX package's v3 sort gives it."""
    R, n = digits.shape
    logn = max(1, (n - 1).bit_length())
    idx = torch.arange(n, device=digits.device, dtype=torch.int64)
    key, _ = torch.sort((digits.to(torch.int64) << logn) | idx, dim=-1)
    S = n // lanes

    def step_major(t):
        return t.reshape(R, lanes, S).transpose(1, 2).to(torch.int32).contiguous()

    return step_major(key >> logn), step_major(key & ((1 << logn) - 1))


def _check_cuda(name: str, *tensors) -> torch.device:
    """The one card of `tensors` (kernels.card_of), which must be
    contiguous int32."""
    dev = K.card_of(name, *tensors)
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} takes contiguous int32 tensors")
    return dev


# --- interior: run accumulation over the sorted stream ------------------

def interior_plain(curve: CurveSpec, px: torch.Tensor, py: torch.Tensor,
                   sdig: torch.Tensor, order: torch.Tensor, nb: int):
    """Plain version of the interior kernel: px/py (8, n) affine bases,
    sdig/order (R, S, K). Returns (buckets JPoint (8, R, nb) with the closed
    interior runs and infinity elsewhere, fragments JPoint (8, R, 2K), their
    digits (R, 2K) int32). The step loop is msm._lane_runs with a digit-0
    point taken as infinity, so bucket 0 and every digit-0 fragment are
    infinity; the kernel's mixed add gives the words of `add_unsafe` with
    Z2 = one."""
    R, S, Kl = sdig.shape
    dev = px.device
    one = M.one_mont(curve.field, dev, 3).expand(W, R, Kl)
    inf = E.infinity((R, Kl), curve, dev)
    idx = order.to(torch.int64)

    def step(t):
        i = idx[:, t]
        d = sdig[:, t]
        return d, E.point_select(d == 0, inf, JPoint(px[:, i], py[:, i], one))

    buckets, bnd, seg = MS._lane_runs(
        curve, step, S, nb, lambda acc, pt: E.add_unsafe(curve, acc, pt))
    buckets = JPoint(*(b[..., :nb].contiguous() for b in buckets))
    return buckets, bnd, seg


def point_major(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """(8, n) affine x and y -> the (n, 16) point-major words the interior
    kernel gathers from: x then y, 64 B a point, four 16-byte loads."""
    return torch.cat([px, py]).t().contiguous()


def interior_cuda(curve: CurveSpec, px: torch.Tensor, py: torch.Tensor,
                  sdig: torch.Tensor, order: torch.Tensor, nb: int):
    """The interior kernel of csrc/msm.cu; the same outputs as
    `interior_plain`. The point-major copy of the bases is made here, at
    each launch: one transposing copy of 8 MB at n = 2^17, held by no
    cache."""
    dev = _check_cuda("msm interior", px, py, sdig, order)
    R, S, Kl = sdig.shape
    pts = point_major(px, py)
    inf = E.infinity((R, nb), curve, dev)
    buckets = JPoint(*(c.contiguous() for c in inf))
    bnd = JPoint(*(torch.empty((W, R, 2 * Kl), dtype=torch.int32, device=dev)
                   for _ in range(3)))
    seg = torch.empty((R, 2 * Kl), dtype=torch.int32, device=dev)
    f = curve.field
    with K.on_card(dev) as stream:
        rc = K.lib("msm").wh2_msm_interior(
            pts.data_ptr(), sdig.data_ptr(), order.data_ptr(), R, S, Kl, nb,
            *(c.data_ptr() for c in buckets), *(c.data_ptr() for c in bnd),
            seg.data_ptr(), K.modulus_words(f), f.n0, K.one_words(f), stream)
    K.check(rc, "msm interior kernel")
    LAUNCHES["msm_interior"] += 1
    return buckets, bnd, seg


def interior(curve, px, py, sdig, order, nb):
    if px.device.type == "cpu":
        return interior_plain(curve, px, py, sdig, order, nb)
    return interior_cuda(curve, px, py, sdig, order, nb)


# --- scan: segment totals of the boundary fragments -----------------------

def scan_plain(curve: CurveSpec, bnd: JPoint, seg: torch.Tensor) -> JPoint:
    """Plain version of the scan kernels: (8, R, M) fragments, (R, M)
    digits, nondecreasing along a row -> at each segment's tail its total
    (infinity for digit 0); other positions unspecified.

    The same adds in the same order as csrc/msm.cu, level by level: tiles
    of SCAN_TILE fragments, each cut into SCAN_THREADS chunks of SCAN_CHUNK;
    (1) a left fold of each chunk, restarting at every digit change; (2) a
    segmented Hillis-Steele scan of the chunks' tail partials within each
    tile, whose value for the chunk before is added in front of a chunk's
    head segment where that closes (every tile's last fragment counts as a
    tail); (3) a tile's first segment that continues from the tile before
    gets the left fold of its earlier tiles' tile-end totals in front."""
    R, Mr = seg.shape
    C = SCAN_CHUNK
    nT = -(-Mr // SCAN_TILE)
    # a row of one tile needs only its own chunks: the kernel's threads
    # past them never reach the ones before
    NT = SCAN_THREADS if nT > 1 else -(-Mr // C)
    T = C * NT
    pad = nT * T - Mr
    dev = seg.device

    def add(a, b):
        return E.add_unsafe(curve, a, b)

    # pad to whole tiles with infinities of digit -1, which no real digit
    # equals
    inf = E.infinity((R, pad), curve, dev)
    f = JPoint(*(torch.cat([c, i], dim=-1) for c, i in zip(bnd, inf)))
    sg = torch.cat([seg, torch.full((R, pad), -1, dtype=seg.dtype, device=dev)], dim=1)
    tiles = sg.reshape(R, nT, T)
    nxt = torch.cat([tiles[..., 1:], torch.full_like(tiles[..., :1], -1)], dim=-1)
    tail = (nxt != tiles).reshape(R, nT * NT, C)

    # 1) left folds of the chunks
    ch = sg.reshape(R, nT * NT, C)
    fc = JPoint(*(c.reshape(W, R, nT * NT, C) for c in f))
    folds = [MS._pt_cols(fc, 0)]
    for j in range(1, C):
        fj = MS._pt_cols(fc, j)
        folds.append(E.point_select(ch[..., j] == ch[..., j - 1], add(folds[-1], fj), fj))
    s = JPoint(*(torch.stack(cs, dim=-1) for cs in zip(*folds)))

    # 2) segmented Hillis-Steele scan of the chunk tail partials in a tile
    dt = ch[..., C - 1].reshape(R, nT, NT)
    inc = JPoint(*(c.reshape(W, R, nT, NT) for c in folds[-1]))
    lane = torch.arange(NT, device=dev)
    d = 1
    while d < NT:
        prev = JPoint(*(torch.roll(c, d, dims=-1) for c in inc))
        ok = (lane >= d) & (dt == torch.roll(dt, d, dims=-1))
        inc = E.point_select(ok, add(prev, inc), inc)
        d *= 2
    before = JPoint(*(torch.roll(c, 1, dims=-1).reshape(W, R, nT * NT, 1)
                      .expand(W, R, nT * NT, C) for c in inc))
    carried = ((lane >= 1) & (ch[..., 0].reshape(R, nT, NT)
                              == torch.roll(dt, 1, dims=-1))).reshape(R, nT * NT, 1)
    use = carried & (ch == ch[..., :1]) & tail
    out = E.point_select(use, add(before, s), s)

    # 3) segments that cross tiles, in tile order: `chain` is the total so
    # far of the segment open at the end of the tile before
    out = JPoint(*(c.reshape(W, R, nT, T) for c in out))
    if nT > 1:
        ends = JPoint(*(c[..., T - 1].clone() for c in out))  # (8, R, nT)
        first = torch.argmax(tail.reshape(R, nT, T).to(torch.int32), dim=-1)
        rows = torch.arange(R, device=dev)
        chain = MS._pt_cols(ends, 0)
        for t in range(1, nT):
            cross = tiles[:, t, 0] == tiles[:, t - 1, T - 1]
            at = first[:, t]
            mine = JPoint(*(c[:, rows, t, at] for c in out))
            for c, v in zip(out, E.point_select(cross, add(chain, mine), mine)):
                c[:, rows, t, at] = v
            e = MS._pt_cols(ends, t)
            chain = E.point_select(cross & (at == T - 1), add(chain, e), e)
    out = JPoint(*(c.reshape(W, R, nT * T)[..., :Mr] for c in out))
    return E.point_select(seg == 0, E.infinity((R, Mr), curve, dev), out)


def scan_cuda(curve: CurveSpec, bnd: JPoint, seg: torch.Tensor) -> JPoint:
    """The scan kernels of csrc/msm.cu on (8, R, M) fragments, (R, M)
    digits: the tile kernel, and the join kernel where a row has more than
    one tile, each launch counted. The same tails as `scan_plain`."""
    bnd = JPoint(*(c.contiguous() for c in bnd))
    dev = _check_cuda("msm scan", *bnd, seg)
    R, m = seg.shape
    tiles = -(-m // SCAN_TILE)
    out = JPoint(*(torch.empty_like(c) for c in bnd))
    head_tail = torch.empty((R, tiles), dtype=torch.int32, device=dev)
    f = curve.field
    with K.on_card(dev) as stream:
        rc = K.lib("msm").wh2_msm_scan(
            *(c.data_ptr() for c in bnd), *(c.data_ptr() for c in out),
            seg.data_ptr(), head_tail.data_ptr(), R, m, SCAN_CHUNK, SCAN_THREADS,
            K.modulus_words(f), f.n0, K.one_words(f), stream)
    K.check(rc, "msm scan kernels")
    LAUNCHES["msm_scan"] += 1 + (tiles > 1)
    return out


def scan(curve, bnd, seg):
    if seg.device.type == "cpu":
        return scan_plain(curve, bnd, seg)
    return scan_cuda(curve, bnd, seg)


def scatter_tails(buckets: JPoint, merged: JPoint, seg: torch.Tensor) -> None:
    """In place: each segment's last fragment (its total) into its bucket.
    A digit with a boundary segment has no interior run, so no write is
    lost."""
    R, nb = buckets.x.shape[1:]
    rows, cols = torch.nonzero(MS._tail_mask(seg), as_tuple=True)
    flat = rows * nb + seg[rows, cols].to(torch.int64)
    for b, v in zip(buckets, merged):
        b.view(W, R * nb)[:, flat] = v[:, rows, cols]


# --- combine: sum_b b * B_b ---------------------------------------------

def _combine_shape(nb: int) -> tuple[int, int]:
    """(G, m): G chunks of m buckets a row, one stage-1 thread each."""
    G = min(COMBINE_G, nb)
    return G, nb // G


def _row_shape(G: int) -> tuple[int, int]:
    """(P, q): a row's stage-2 block has P threads, which fold q of its G
    chunk partials each."""
    P = min(COMBINE_ROW_THREADS, G)
    return P, G // P


def _fold_from_top(curve: CurveSpec, part, k: int, inf: JPoint):
    """Over part(k - 1), ..., part(0): the running sum (unsafe adds, its
    operands are sums of disjoint ranges) and the weighted sum
    sum_{i >= 1} run_i = sum_i i part(i) (complete adds: a running sum
    repeats where part(i) is infinity). Infinity as the weighted sum for
    k = 1."""
    run = part(k - 1)
    w = run if k > 1 else inf
    for i in range(k - 2, 0, -1):
        run = E.add_unsafe(curve, run, part(i))
        w = E.add(curve, w, run)
    if k > 1:
        run = E.add_unsafe(curve, run, part(0))
    return run, w


def combine_plain(curve: CurveSpec, buckets: JPoint) -> JPoint:
    """Plain version of the combine kernels: buckets (8, R, nb) -> (8, R),
    sum_b b B_b, with the adds of csrc/combine.cu in the same order.

    Stage 1, chunk g of buckets g m .. g m + m - 1: its total T_g and
    W_g = sum_i i B_{g m + i}, folded from the top. Stage 2, with
    X = sum_g g T_g and Y = sum_g W_g the sum is m X + Y: row thread t folds
    partials t q .. t q + q - 1 from the top into T'_t, L_t =
    sum_j j T_{t q + j} and Y_t = sum_j W_{t q + j}; an inclusive
    Hillis-Steele suffix of the T'_t gives E_t, and since
    X = q sum_{t >= 1} E_t + sum_t L_t, the sum is the total of
    U_t = m q E_t (t >= 1) + (m L_t + Y_t), one tree over the threads."""
    R, nb = buckets.x.shape[1:]
    G, m = _combine_shape(nb)
    P, q = _row_shape(G)
    dev = buckets.x.device
    add_u = lambda a, b: E.add_unsafe(curve, a, b)  # noqa: E731
    add_c = lambda a, b: E.add(curve, a, b)  # noqa: E731

    # 1) chunk pass
    ch = JPoint(*(c.reshape(W, R, G, m) for c in buckets))
    tot, wgt = _fold_from_top(curve, lambda i: MS._pt_cols(ch, i), m,
                              E.infinity((R, G), curve, dev))

    # 2) row threads: fold q partials each
    tq = JPoint(*(c.reshape(W, R, P, q) for c in tot))
    wq = JPoint(*(c.reshape(W, R, P, q) for c in wgt))
    inf = E.infinity((R, P), curve, dev)
    run, l = _fold_from_top(curve, lambda j: MS._pt_cols(tq, j), q, inf)
    y = MS._pt_cols(wq, q - 1)
    for j in range(q - 2, -1, -1):
        y = add_u(y, MS._pt_cols(wq, j))
    lane = torch.arange(P, device=dev).expand(R, P)

    def shifted(p, d):  # lane t sees lane t + d (wrapping, masked by callers)
        return JPoint(*(torch.roll(c, -d, dims=-1) for c in p))

    e = run
    d = 1
    while d < P:
        e = E.point_select(lane < P - d, add_u(e, shifted(e, d)), e)
        d *= 2

    def times(p, k):  # k a power of two: log2 k doublings
        while k > 1:
            p = E.double(curve, p)
            k //= 2
        return p

    u = E.point_select(lane == 0, inf, times(e, m * q))
    u = add_c(u, add_c(times(l, m), y))
    d = P // 2
    while d >= 1:
        u = E.point_select(lane < d, add_c(u, shifted(u, d)), u)
        d //= 2
    return JPoint(*(c[..., 0] for c in u))


def combine_cuda(curve: CurveSpec, buckets: JPoint) -> JPoint:
    """The combine kernels of csrc/combine.cu (the chunk pass, then the row
    reduction: two launches, one wrapper call counted): buckets (8, R, nb)
    -> (8, R)."""
    buckets = JPoint(*(c.contiguous() for c in buckets))
    dev = _check_cuda("msm combine", *buckets)
    R, nb = buckets.x.shape[1:]
    G, _ = _combine_shape(nb)
    P, _ = _row_shape(G)
    out = JPoint(*(torch.empty((W, R), dtype=torch.int32, device=dev)
                   for _ in range(3)))
    part = torch.empty((6, W, R * G), dtype=torch.int32, device=dev)
    f = curve.field
    lib = K.lib("combine")
    with K.on_card(dev) as stream:
        consts = (K.modulus_words(f), f.n0, K.one_words(f), stream)
        rc = lib.wh2_msm_combine_chunks(*(c.data_ptr() for c in buckets),
                                        part.data_ptr(), R, nb, G, *consts)
        K.check(rc, "msm combine chunk kernel")
        rc = lib.wh2_msm_combine_rows(part.data_ptr(), *(c.data_ptr() for c in out),
                                      R, nb, G, P, *consts)
    K.check(rc, "msm combine row kernel")
    LAUNCHES["msm_combine"] += 1
    return out


def combine(curve, buckets):
    if buckets.x.device.type == "cpu":
        return combine_plain(curve, buckets)
    return combine_cuda(curve, buckets)


# --- the pipeline ---------------------------------------------------------

def window_sums(curve: CurveSpec, points: JPoint, scalars_mont: torch.Tensor,
                c: int, lanes: int) -> JPoint:
    """B MSMs through the pipeline: points (8, n) affine, scalars (8, B, n)
    Montgomery Fr -> window sums JPoint of (8, Wn, B)."""
    _, B, n = scalars_mont.shape
    std = M.normalize(FR_SPEC, M.from_mont(FR_SPEC, scalars_mont))
    digits = MS.scalar_digits(std, c)  # (Wn, B, n)
    nwin = digits.shape[0]
    sdig, order = sorted_stream(digits.reshape(nwin * B, n), lanes)
    nb = 1 << c
    buckets, bnd, seg = interior(curve, points.x, points.y, sdig, order, nb)
    merged = scan(curve, bnd, seg)
    scatter_tails(buckets, merged, seg)
    wsums = combine(curve, buckets)
    return JPoint(*(t.reshape(W, nwin, B) for t in wsums))


def msm_batch(curve: CurveSpec, points: JPoint, scalars_batch: torch.Tensor,
              c: int | None = None) -> list:
    """B MSMs sharing one base set: scalars (8, B, n) Montgomery Fr ->
    B host affine points (None for infinity)."""
    n = scalars_batch.shape[-1]
    c = c if c is not None else MS._default_c(n)
    return MS._host_horner(curve, window_sums(curve, points, scalars_batch,
                                              c, lanes_for(n)), c)


def msm(curve: CurveSpec, points: JPoint, scalars_mont: torch.Tensor,
        c: int | None = None):
    """One MSM: scalars (8, n) Montgomery Fr -> host affine point."""
    return msm_batch(curve, points, scalars_mont[:, None, :], c)[0]
