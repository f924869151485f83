// The bucket combine of the v3 Pippenger commit pipeline over bn254 G1:
// for each window row, sum_{b >= 1} b * B_b over its nb buckets. Driven by
// ops/msm_fused.py (`combine_cuda`), after the interior and scan kernels
// of csrc/msm.cu.
//
// Replaces the TPU kernel webauthn_halo2_tpu/ops/msm_pallas.py _combine
// (_combine_kernel): one grid step per row, the row's buckets in VMEM as an
// (m, G = 512) block, a within-chunk pass, a cross-chunk Hillis-Steele
// suffix over the 512 lanes and two lane trees.
//
// What bounds it on an H100: operations. The least work is about two
// Jacobian adds per non-empty bucket up to the row's top one (running sums
// S_b = S_{b+1} + B_b, and their sum); the buckets are 96 B each, 786 KB a
// row, read once. A row is 8192 buckets, and a batch has R = 20 to 180
// rows, so a single block per row would fill at most R of the 132 SMs and
// leave the trees' latency tails on a whole SM.
//
// Design: two launches, the work of a row spread over the card.
//   1. msm_combine_chunk_kernel, one thread per (row, chunk of m buckets),
//      COMBINE_CHUNK_THREADS a block, no barriers: the row's G = nb / m
//      chunks are G threads, so a one-MSM batch (R = 20) is 20 G threads
//      over the whole card. Thread g walks its buckets g m + m - 1 .. g m
//      from the top with the running sum run (unsafe add: disjoint
//      buckets) and the weighted sum W_g = sum_{i >= 1} run_i =
//      sum_i i B_{g m + i} (complete add: run_i repeats over empty
//      buckets), the next bucket's load issued before the current adds. It
//      stores its chunk total T_g and W_g.
//   2. msm_combine_row_kernel, one block of P threads per row, a short
//      stage: it reads G partials a row where stage 1 reads nb buckets.
//      With X = sum_g g T_g and Y = sum_g W_g, the row's sum is m X + Y.
//      Thread t folds its q = G / P partials t q .. t q + q - 1 from the
//      top, as stage 1 folds buckets: its total T'_t (unsafe),
//      L_t = sum_{j >= 1} run_j = sum_j j T_{t q + j} (complete) and
//      Y_t = sum_j W_{t q + j} (unsafe). A Hillis-Steele suffix of the P
//      thread totals in shared memory (log2 P steps, unsafe: disjoint
//      ranges) gives E_t = sum_{t' >= t} T'_t', and as
//      X = q sum_{t >= 1} E_t + sum_t L_t, the row's sum is the total of
//      U_t = m q E_t (t >= 1) + (m L_t + Y_t). Each thread forms its U_t at
//      once (log2 (m q) and log2 m doublings, two complete adds), and one
//      tree of complete adds (U_t repeat where E_t do) gives the total in
//      thread 0: about three adds a chunk.
// A thread's adds are a chain of dependent instructions (each multiply a
// carry chain), so a warp alone on its scheduler waits on every
// instruction: a tree level costs the latency of one add, not its issue
// time. Stage 2 is latency-bound where R is small, which is why its
// weights are applied per thread before the one tree rather than by
// doublings after three. G and P are chosen by measurement on a proof's
// commit batches (scripts/sweep_torch_kernels.py; ops/msm_fused.py
// COMBINE_G, COMBINE_ROW_THREADS). A block of P = 256 threads at about
// 220 registers fills an SM's register file, so above 132 rows stage 2
// runs in two waves; blocks of 128 threads (two an SM) ran faster on a
// proof's 140-row batch but slower on its 160-row one, so P stays 256.
// The EC bodies are compiled inline here (EC_BODY), so the points stay in
// registers, on the 64-bit C multiply (EC_MUL, below). The order of every
// add is fixed; combine_plain in ops/msm_fused.py performs the same adds
// in the same order on tensors. It associates the sum otherwise than the
// JAX kernel, so the window sums may be other Jacobian representatives of
// the same points. Bucket 0 gets no weight: it enters only chunk 0's
// total, and T_0 only E_0, which the sum leaves out.
#include <cuda_runtime.h>

// The EC bodies inline, on the 64-bit C multiply and square of field.cuh:
// this kernel's adds are latency-bound chains, and with the carry-chain
// PTX multiply the two launches took about a third longer over a proof's
// commit batches (PERF.md).
#define EC_BODY __forceinline__
#define EC_MUL fe_montmul_c64
#define EC_SQR fe_sqr_c64
#include "ec.cuh"

#define COMBINE_CHUNK_THREADS 128
#define COMBINE_ROW_THREADS 256

// Buckets (8, R * nb), bucket g m + i of row r at element r nb + g m + i.
// Writes T_g and W_g of row r to element r G + g of t* and w* (8, R * G).
__global__ void __launch_bounds__(COMBINE_CHUNK_THREADS) msm_combine_chunk_kernel(
    const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
    const uint32_t* __restrict__ bz, uint32_t* __restrict__ tx, uint32_t* __restrict__ ty,
    uint32_t* __restrict__ tz, uint32_t* __restrict__ wx, uint32_t* __restrict__ wy,
    uint32_t* __restrict__ wz, int R, int nb, int G, int m, Modulus mod, Fe one) {
  const long long tid = (long long)blockIdx.x * COMBINE_CHUNK_THREADS + threadIdx.x;
  if (tid >= (long long)R * G) return;
  const int r = (int)(tid / G);
  const int g = (int)(tid - (long long)r * G);
  const long long ls = (long long)R * nb;
  const long long base = (long long)r * nb + (long long)g * m;
  Pt run = pt_load(bx, by, bz, ls, base + m - 1);
  Pt w = run;
  Pt nxt = run;
  if (m > 1) nxt = pt_load(bx, by, bz, ls, base + m - 2);
  for (int i = m - 2; i >= 1; --i) {
    const Pt b = nxt;
    nxt = pt_load(bx, by, bz, ls, base + i - 1);
    run = ec_add_unsafe(run, b, mod);
    w = ec_add(w, run, mod, one);
  }
  if (m > 1) run = ec_add_unsafe(run, nxt, mod);
  if (m == 1) w = pt_infinity(one);
  const long long pls = (long long)R * G;
  pt_store(tx, ty, tz, pls, tid, run);
  pt_store(wx, wy, wz, pls, tid, w);
}

// p doubled log2(k) times (k a power of two).
__device__ __forceinline__ Pt ec_times(Pt p, int k, const Modulus& mod) {
  for (; k > 1; k >>= 1) p = ec_double(p, mod);
  return p;
}

// One block of P = blockDim.x threads per row r over the row's G chunk
// partials; writes the row's sum to element r of out (8, R).
__global__ void __launch_bounds__(COMBINE_ROW_THREADS) msm_combine_row_kernel(
    const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
    const uint32_t* __restrict__ tz, const uint32_t* __restrict__ wx,
    const uint32_t* __restrict__ wy, const uint32_t* __restrict__ wz,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int R,
    int G, int m, Modulus mod, Fe one) {
  __shared__ uint32_t sm[3 * NW * COMBINE_ROW_THREADS];
  const int P = blockDim.x;
  const int t = threadIdx.x;
  const int r = blockIdx.x;
  const int q = G / P;
  const long long ls = (long long)R * G;
  const long long base = (long long)r * G + (long long)t * q;

  // 1) the thread's q partials from the top: T'_t, L_t, Y_t
  Pt run = pt_load(tx, ty, tz, ls, base + q - 1);
  Pt l = q > 1 ? run : pt_infinity(one);
  Pt y = pt_load(wx, wy, wz, ls, base + q - 1);
  for (int j = q - 2; j >= 0; --j) {
    run = ec_add_unsafe(run, pt_load(tx, ty, tz, ls, base + j), mod);
    if (j >= 1) l = ec_add(l, run, mod, one);
    y = ec_add_unsafe(y, pt_load(wx, wy, wz, ls, base + j), mod);
  }

  // 2) inclusive suffix of the thread totals: E_t
  Pt e = run;
  for (int d = 1; d < P; d <<= 1) {
    sm_store(sm, P, t, e);
    __syncthreads();
    if (t < P - d) e = ec_add_unsafe(e, sm_load(sm, P, t + d), mod);
    __syncthreads();
  }

  // 3) U_t = m q E_t (t >= 1) + (m L_t + Y_t), each thread at once
  Pt u = ec_times(e, m * q, mod);
  if (t == 0) u = pt_infinity(one);
  u = ec_add(u, ec_add(ec_times(l, m, mod), y, mod, one), mod, one);

  // 4) one tree of complete adds into thread 0
  for (int d = P >> 1; d >= 1; d >>= 1) {
    if (t < 2 * d) sm_store(sm, P, t, u);
    __syncthreads();
    if (t < d) u = ec_add(u, sm_load(sm, P, t + d), mod, one);
    __syncthreads();
  }
  if (t == 0) pt_store(ox, oy, oz, R, r, u);
}

static bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

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

// The two launches of the combine, one C entry each (ops/msm_fused.py
// `combine_cuda` makes both). part: (6, 8, R * G) words, T then W, x y z
// each.

// Stage 1: buckets (8, R * nb) -> the chunk partials of G chunks a row.
extern "C" int wh2_msm_combine_chunks(const void* bx, const void* by, const void* bz,
                                      void* part, int R, int nb, int G,
                                      const uint32_t* p_words, uint32_t n0,
                                      const uint32_t* one_words, void* stream) {
  if (!pow2(nb) || !pow2(G) || G > nb) return (int)cudaErrorInvalidValue;
  const long long pls = (long long)NW * R * G;
  uint32_t* pt = (uint32_t*)part;
  const long long threads = (long long)R * G;
  msm_combine_chunk_kernel<<<(unsigned)((threads + COMBINE_CHUNK_THREADS - 1) /
                                        COMBINE_CHUNK_THREADS),
                             COMBINE_CHUNK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz, pt, pt + pls,
      pt + 2 * pls, pt + 3 * pls, pt + 4 * pls, pt + 5 * pls, R, nb, G, nb / G,
      make_modulus(p_words, n0), make_fe(one_words));
  return (int)cudaGetLastError();
}

// Stage 2: the chunk partials -> out (8, R), P threads a row.
extern "C" int wh2_msm_combine_rows(const void* part, void* ox, void* oy, void* oz, int R,
                                    int nb, int G, int P, const uint32_t* p_words, uint32_t n0,
                                    const uint32_t* one_words, void* stream) {
  if (!pow2(nb) || !pow2(G) || !pow2(P) || G > nb || P > G || P > COMBINE_ROW_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long pls = (long long)NW * R * G;
  const uint32_t* pt = (const uint32_t*)part;
  msm_combine_row_kernel<<<(unsigned)R, P, 0, (cudaStream_t)stream>>>(
      pt, pt + pls, pt + 2 * pls, pt + 3 * pls, pt + 4 * pls, pt + 5 * pls, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, R, G, nb / G, make_modulus(p_words, n0),
      make_fe(one_words));
  return (int)cudaGetLastError();
}
