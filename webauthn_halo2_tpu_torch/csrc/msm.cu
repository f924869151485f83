// The v3 Pippenger commit pipeline over bn254 G1: interior run
// accumulation and segmented reduction of the lane-boundary fragments. The
// bucket combine sum_b b * B_b that follows is csrc/combine.cu. Driven by
// ops/msm_fused.py.
//
// Replaces the TPU kernels of webauthn_halo2_tpu/ops/msm_pallas.py:
//   * msm_interior_kernel  <- _interior_v2 (_interior_kernel_v2), and the
//     same function as v1's _interior (_interior_kernel);
//   * msm_scan_tile_kernel + msm_scan_join_kernel <- _scan_pallas
//     (_scan_kernel).
//
// Rows: row r is window w of MSM b (r = w * B + b), each with its own
// sorted digit stream. Bucket arrays are (8, R * nb) word-major, bucket b of
// row r at element r * nb + b; boundary fragments (8, R * 2K) likewise.
//
// Two things differ from what the TPU kernels return; the window sums are
// the same points, and so every commitment is the same:
//   1. Points whose digit is 0 contribute nothing: bucket 0, and every
//      boundary fragment labelled with digit 0, hold infinity. The combine
//      gives bucket 0 no weight: B_0 enters only chunk 0's total T_0, T_0
//      only the first row thread's total and suffix E_0, which the window
//      sum leaves out, and each weighted sum adds run_i for i >= 1 only
//      (csrc/combine.cu; msm_pallas._combine_kernel likewise). The segment
//      ids are unchanged, and every digit != 0 gets the same madds in the
//      same order, so the same words.
//   2. The scan returns segment totals, not an inclusive scan: at the tail
//      of each segment with a nonzero digit, the segment's total; at a
//      digit-0 tail, infinity; other positions are left unwritten. The tail
//      scatter reads nothing else. The totals associate the adds otherwise
//      than the Hillis-Steele scan does, so they may be other Jacobian
//      representatives of the same points.
//
// Interior. What bounds it on an H100: each step is one mixed add, 11
// Montgomery multiplies of 256 32-bit multiply-adds (three of them squares
// of 200), on 64 bytes of point gathered from the SRS (which fits the
// 50 MB L2 at k = 17): operations, not bytes. The TPU walks the S steps as a
// sequential grid axis with the lane state in VMEM; here one thread owns one
// (row, lane) and loops over its S steps with the accumulator in registers.
// The sort puts digit 0 first in every row, so a lane's digit-0 steps are a
// prefix of its steps: a lane whose last digit is 0 stores (0, infinity)
// twice and returns; a lane that opens in digit 0 reads digits only up to
// its first nonzero step, stores fragment A = (0, infinity), and gathers
// nothing for those steps. The bases come point-major, (n, 16) words (x then
// y, 64 B a point), so a gather is four 16-byte non-coherent loads over two
// L2 sectors; the point of step t + 1 and the index of step t + 2 are
// loaded before step t's add. The TPU emits a mostly infinite point every
// step and recovers buckets with searchsorted + gather because Mosaic has no
// scatter; here a closed run that is not its lane's first holds every point
// of its digit (the stream is sorted and the run has other digits on both
// sides), so it is stored straight into its bucket, with no other writer.
// The digit/index stream is step-major (R, S, K), so a warp's loads of one
// step coalesce. 256 threads a block: faster than 128 summed over a proof's
// commit batches, though 128 wins on sparse columns.
//
// Scan. A row has M = 2K fragments of 96 bytes in segments of equal digit;
// one segment may span thousands of them (a 0/1 selector column puts most of
// window 0 in digit 1), most are one or two long. Only each segment's total
// is needed. No Hillis-Steele pass loop through global memory: three levels
// of a segmented reduction.
//   1. msm_scan_tile_kernel, one block per (row, tile of SCAN_TILE = 512
//      fragments), so a one-MSM batch (R = 20, M = 4096) has 160 blocks.
//      Each of its 128 threads folds its chunk of 4 consecutive fragments
//      serially in registers, left to right, restarting at each digit change,
//      and stores at once the total of every segment that opens and closes
//      in the chunk. (Chunks of 4 on 128 threads ran faster than chunks of 8
//      on 64: a warp pays for an add at a chunk position if any of its lanes
//      needs one there.)
//   2. The chunks' tail partials (the fold at the chunk's end) and their
//      digits go through shared memory (128 x 96 B): a segmented inclusive
//      Hillis-Steele scan over the 128 chunks, log2(128) = 7 steps, each a
//      read and an add between two barriers. A chunk whose head segment
//      began in an earlier chunk adds the scan value of the chunk before to
//      its head piece where that segment closes (or reaches the tile's end).
//      Every tile's last fragment is treated as a tail, and the block
//      records the position of its first tail.
//   3. msm_scan_join_kernel, one thread per (row, tile): a tile whose first
//      segment continues from the tile before, and closes in this tile,
//      adds the tile-end totals of that segment's earlier tiles, left to
//      right from the tile where it starts, in front of its own piece.
// Digit-0 fragments are neither loaded nor added. Every add is the
// infinity-aware unsafe add: every operand is a sum of a disjoint set of
// SRS points. The order of the adds is fixed; scan_plain in ops/msm_fused.py
// performs the same adds in the same order on tensors. What bounds it: a
// Jacobian add is 16 multiplies (four of them squares), and the least work
// is one add per finite fragment beyond its segment's first finite one
// (digit != 0); level 2 adds at most seven steps and level 3 one add per
// tile a segment crosses.
#include <cuda_runtime.h>

#include "ec.cuh"

#define INTERIOR_THREADS 256
#define SCAN_THREADS 128
#define SCAN_CHUNK 4
#define SCAN_TILE (SCAN_THREADS * SCAN_CHUNK)
#define JOIN_THREADS 128

static Modulus make_modulus(const uint32_t* p_words, uint32_t n0) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = n0;
  return m;
}

static Fe make_fe(const uint32_t* words) {
  Fe r;
  for (int i = 0; i < NW; ++i) r.w[i] = words[i];
  return r;
}

// Affine point idx of the point-major bases: four 16-byte loads.
__device__ __forceinline__ void load_affine(const uint4* __restrict__ pts, int idx, Fe& x, Fe& y) {
  const uint4* p = pts + 4 * (long long)idx;
  const uint4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2), d = __ldg(p + 3);
  x.w[0] = a.x; x.w[1] = a.y; x.w[2] = a.z; x.w[3] = a.w;
  x.w[4] = b.x; x.w[5] = b.y; x.w[6] = b.z; x.w[7] = b.w;
  y.w[0] = c.x; y.w[1] = c.y; y.w[2] = c.z; y.w[3] = c.w;
  y.w[4] = d.x; y.w[5] = d.y; y.w[6] = d.z; y.w[7] = d.w;
}

// One thread per (row, lane). pts: (n, 16) affine Montgomery SRS words, x
// then y. sdig/order: (R, S, K) sorted digits and point indices, lane k
// holding sorted positions [k S, (k + 1) S). Buckets must hold infinity on
// entry; bucket 0 is never written.
__global__ void __launch_bounds__(INTERIOR_THREADS) msm_interior_kernel(
    const uint4* __restrict__ pts, const int* __restrict__ sdig, const int* __restrict__ order,
    int R, int S, int K, int nb, uint32_t* __restrict__ bx, uint32_t* __restrict__ by,
    uint32_t* __restrict__ bz, uint32_t* __restrict__ fx, uint32_t* __restrict__ fy,
    uint32_t* __restrict__ fz, int* __restrict__ seg, Modulus m, Fe one) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)R * K) return;
  const int r = (int)(tid / K);
  const int k = (int)(tid - (long long)r * K);
  const long long base = (long long)r * S * K + k;
  const int* dg = sdig + base;  // step t of this lane at dg[t * K]
  const int* ix = order + base;
  const long long b_ls = (long long)R * nb;
  const long long f_ls = (long long)R * 2 * K;
  const long long slot = (long long)r * 2 * K + 2 * k;

  // digits are sorted, so a lane ending in digit 0 holds nothing else
  if (dg[(long long)(S - 1) * K] == 0) {
    const Pt inf = pt_infinity(one);
    pt_store(fx, fy, fz, f_ls, slot, inf);
    pt_store(fx, fy, fz, f_ls, slot + 1, inf);
    seg[slot] = 0;
    seg[slot + 1] = 0;
    return;
  }
  int t = 0;
  int cur = dg[0];
  bool has_first = false;
  if (cur == 0) {  // the first run is digit 0: fragment A holds infinity
    do {
      cur = dg[(long long)(++t) * K];
    } while (cur == 0);
    pt_store(fx, fy, fz, f_ls, slot, pt_infinity(one));
    seg[slot] = 0;
    has_first = true;
  }
  Pt acc;
  load_affine(pts, ix[(long long)t * K], acc.x, acc.y);
  acc.z = one;
  // in flight during step t's add: step t + 1's digit and point, step
  // t + 2's index
  int dn = 0, in2 = 0;
  Fe nx, ny;
  if (t + 1 < S) {
    dn = dg[(long long)(t + 1) * K];
    load_affine(pts, ix[(long long)(t + 1) * K], nx, ny);
  }
  if (t + 2 < S) in2 = ix[(long long)(t + 2) * K];
  for (++t; t < S; ++t) {
    const int d = dn;
    const Fe qx = nx, qy = ny;
    if (t + 1 < S) {
      dn = dg[(long long)(t + 1) * K];
      load_affine(pts, in2, nx, ny);
    }
    if (t + 2 < S) in2 = ix[(long long)(t + 2) * K];
    if (d != cur) {
      if (!has_first) {
        pt_store(fx, fy, fz, f_ls, slot, acc);
        seg[slot] = cur;
        has_first = true;
      } else {
        pt_store(bx, by, bz, b_ls, (long long)r * nb + cur, acc);
      }
      acc.x = qx;
      acc.y = qy;
      acc.z = one;
      cur = d;
    } else {
      acc = ec_madd(acc, qx, qy, m);
    }
  }
  if (!has_first) {
    pt_store(fx, fy, fz, f_ls, slot, pt_infinity(one));
    seg[slot] = cur;
  }
  pt_store(fx, fy, fz, f_ls, slot + 1, acc);
  seg[slot + 1] = cur;
}

// Levels 1 and 2 of the scan. Fragments in/out (8, R * M), fragment i of row
// r at element r * M + i; seg (R, M) digits, nondecreasing along a row.
// Block (r, tile): positions [tile * SCAN_TILE, ...) of row r, thread c the
// chunk [c * SCAN_CHUNK, (c + 1) * SCAN_CHUNK) of the tile. Writes, at every
// tail of the tile (a digit change, or the tile's last fragment), the
// segment's total over this tile, and head_tail[r * tiles + tile] = the
// offset in the tile of its first tail.
__global__ void __launch_bounds__(SCAN_THREADS) msm_scan_tile_kernel(
    const uint32_t* __restrict__ ix, const uint32_t* __restrict__ iy,
    const uint32_t* __restrict__ iz, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, const int* __restrict__ seg, int* __restrict__ head_tail, int M,
    int tiles, long long ls, Modulus m, Fe one) {
  __shared__ uint32_t sp[3 * NW * SCAN_THREADS];  // chunk partials, word-major
  __shared__ int sd[SCAN_THREADS];                // their digits
  __shared__ int first_tail;
  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x - row * tiles;
  const int c = threadIdx.x;
  const long long rb = (long long)row * M;
  const int t0 = tile * SCAN_TILE;
  const int lo = t0 + c * SCAN_CHUNK;
  const int tile_last = min(M, t0 + SCAN_TILE) - 1;
  const int n = max(0, min(SCAN_CHUNK, M - lo));
  if (c == 0) first_tail = SCAN_TILE;

  // the chunk's digits, and the next one in the tile (-1: none)
  int dg[SCAN_CHUNK + 1];
#pragma unroll
  for (int j = 0; j <= SCAN_CHUNK; ++j) {
    const int p = lo + j;
    dg[j] = (j < n || (j == n && p <= tile_last)) ? seg[rb + p] : -1;
  }

  // 1) fold the chunk; s is the running total of the current segment
  Pt s = pt_infinity(one), hs = s;
  int head_end = -1;  // where the chunk's first segment closes, if it does
#pragma unroll
  for (int j = 0; j < SCAN_CHUNK; ++j) {
    if (j < n) {
      const int d = dg[j];
      if (d == 0) {
        s = pt_infinity(one);
      } else {
        const Pt f = pt_load(ix, iy, iz, ls, rb + lo + j);
        s = (j > 0 && d == dg[j - 1]) ? ec_add_unsafe(s, f, m) : f;
      }
      if (dg[j + 1] != d) {  // a tail
        if (d == dg[0]) {
          head_end = j;
          hs = s;
        } else {
          pt_store(ox, oy, oz, ls, rb + lo + j, s);
        }
      }
    }
  }
  const int dt = n > 0 ? dg[n - 1] : -1;

  // 2) segmented inclusive scan of the chunks' tail partials
  sd[c] = dt;
  Pt inc = s;
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    sm_store(sp, SCAN_THREADS, c, inc);
    __syncthreads();
    if (c >= d && dt > 0 && sd[c - d] == dt) inc = ec_add_unsafe(sm_load(sp, SCAN_THREADS, c - d), inc, m);
    __syncthreads();
  }
  sm_store(sp, SCAN_THREADS, c, inc);
  __syncthreads();
  if (head_end >= 0) {
    if (c > 0 && dg[0] > 0 && sd[c - 1] == dg[0])
      hs = ec_add_unsafe(sm_load(sp, SCAN_THREADS, c - 1), hs, m);
    pt_store(ox, oy, oz, ls, rb + lo + head_end, hs);
    atomicMin(&first_tail, c * SCAN_CHUNK + head_end);
  }
  __syncthreads();
  if (c == 0) head_tail[(long long)row * tiles + tile] = first_tail;
}

// Level 3 of the scan: one thread per (row, tile). A tile whose first
// segment continues from the tile before and closes in this tile adds, in
// front of its own tile total at that segment's tail, the tile-end totals of
// the segment's earlier tiles, left to right from the tile where it starts.
// No other thread writes what this one reads.
__global__ void __launch_bounds__(JOIN_THREADS) msm_scan_join_kernel(
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
    const int* __restrict__ seg, const int* __restrict__ head_tail, int R, int M, int tiles,
    long long ls, Modulus m) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)R * tiles) return;
  const int row = (int)(tid / tiles);
  const int t = (int)(tid - (long long)row * tiles);
  const long long rb = (long long)row * M;
  const int* ht = head_tail + (long long)row * tiles;
  const int a = t * SCAN_TILE;
  if (t == 0) return;
  const int d = seg[rb + a];
  if (d == 0 || seg[rb + a - 1] != d) return;
  const int h = a + ht[t];
  if (h + 1 < M && seg[rb + h + 1] == d) return;  // closes in a later tile
  int u = t - 1;  // back to the tile where the segment starts
  while (u > 0 && ht[u] == SCAN_TILE - 1 && seg[rb + (long long)u * SCAN_TILE - 1] == d) --u;
  Pt acc = pt_load(ox, oy, oz, ls, rb + (long long)(u + 1) * SCAN_TILE - 1);
  for (int v = u + 1; v < t; ++v)
    acc = ec_add_unsafe(acc, pt_load(ox, oy, oz, ls, rb + (long long)(v + 1) * SCAN_TILE - 1), m);
  pt_store(ox, oy, oz, ls, rb + h, ec_add_unsafe(acc, pt_load(ox, oy, oz, ls, rb + h), m));
}

extern "C" int wh2_msm_interior(const void* pts, const void* sdig, const void* order, int R,
                                int S, int K, int nb, void* bx, void* by, void* bz, void* fx,
                                void* fy, void* fz, void* seg, const uint32_t* p_words,
                                uint32_t n0, const uint32_t* one_words, void* stream) {
  const long long blocks = ((long long)R * K + INTERIOR_THREADS - 1) / INTERIOR_THREADS;
  msm_interior_kernel<<<(unsigned)blocks, INTERIOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)pts, (const int*)sdig, (const int*)order, R, S, K, nb, (uint32_t*)bx,
      (uint32_t*)by, (uint32_t*)bz, (uint32_t*)fx, (uint32_t*)fy, (uint32_t*)fz, (int*)seg,
      make_modulus(p_words, n0), make_fe(one_words));
  return (int)cudaGetLastError();
}

// chunk and threads must be the kernel's SCAN_CHUNK and SCAN_THREADS (the
// plain version in ops/msm_fused.py follows the same tiling). Launches the
// tile kernel and, where a row has more than one tile, the join kernel.
extern "C" int wh2_msm_scan(const void* ix, const void* iy, const void* iz, void* ox, void* oy,
                            void* oz, const void* seg, void* head_tail, int R, int M, int chunk,
                            int threads, const uint32_t* p_words, uint32_t n0,
                            const uint32_t* one_words, void* stream) {
  if (chunk != SCAN_CHUNK || threads != SCAN_THREADS) return (int)cudaErrorInvalidValue;
  const int tiles = (M + SCAN_TILE - 1) / SCAN_TILE;
  const long long ls = (long long)R * M;
  const Modulus m = make_modulus(p_words, n0);
  cudaStream_t s = (cudaStream_t)stream;
  msm_scan_tile_kernel<<<(unsigned)((long long)R * tiles), SCAN_THREADS, 0, s>>>(
      (const uint32_t*)ix, (const uint32_t*)iy, (const uint32_t*)iz, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, (const int*)seg, (int*)head_tail, M, tiles, ls, m,
      make_fe(one_words));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  const long long jt = (long long)R * tiles;
  msm_scan_join_kernel<<<(unsigned)((jt + JOIN_THREADS - 1) / JOIN_THREADS), JOIN_THREADS, 0, s>>>(
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (const int*)seg, (const int*)head_tail, R, M,
      tiles, ls, m);
  return (int)cudaGetLastError();
}
