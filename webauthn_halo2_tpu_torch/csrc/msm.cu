// The v3 Pippenger commit pipeline over bn254 G1: interior run
// accumulation, segmented scan of the lane-boundary fragments, and the
// bucket combine sum_b b * B_b. Driven by ops/msm_fused.py.
//
// Replaces the TPU kernels of webauthn_halo2_tpu/ops/msm_pallas.py:
//   * msm_interior_kernel <- _interior_v2 (_interior_kernel_v2), and the
//     same function as v1's _interior (_interior_kernel);
//   * msm_scan_kernel     <- _scan_pallas (_scan_kernel);
//   * msm_combine_kernel  <- _combine (_combine_kernel).
//
// Rows: row r is window w of MSM b (r = w * B + b), each with its own
// sorted digit stream. Bucket arrays are (8, R * nb) word-major, bucket b of
// row r at element r * nb + b; boundary fragments (8, R * 2K) likewise.
//
// Interior. What bounds it on an H100: each step is one mixed add, 11
// Montgomery multiplies of 256 32-bit multiply-adds, on 64 bytes of point
// gathered from the SRS (which fits the 50 MB L2 at k = 17): operations,
// not bytes. The TPU walks the S steps as a sequential grid axis with the
// lane state in VMEM; here one thread owns one (row, lane) and loops over
// its S steps with the accumulator in registers. The TPU emits a mostly
// infinite point every step and recovers buckets with searchsorted + gather
// because Mosaic has no scatter; here a closed run that is not its lane's
// first holds every point of its digit (the stream is sorted and the run has
// other digits on both sides), so it is stored straight into its bucket,
// with no other writer. The digit/index stream is step-major (R, S, K), so
// a warp's loads of one step coalesce; the thread gathers its own affine
// point from the SRS, so there is no sorted copy of the coordinates.
//
// Scan. Bounded by operations: a Jacobian add is 16 multiplies. The TPU
// holds a row's 2K fragments in VMEM (about 23 MB of intermediates); at
// K = 2048 the 4096 fragments of 96 bytes do not fit a block's 227 KB of
// shared memory, so one block per row runs the Hillis-Steele passes through
// global memory (ping-pong between two buffers, L2-resident), with
// __syncthreads between passes. An add is done only where the fragment and
// its partner d back share a segment; most segments are one or two long, so
// most passes only copy.
//
// Combine. Bounded by operations (m unsafe and m complete adds per chunk,
// then three trees of G adds per row, on 786 KB of buckets). One block per
// row, thread g owns chunk g (buckets g m .. g m + m - 1): it walks them from
// the top with the running sum (unsafe add) and the weighted sum W_g
// (complete add) in registers. The cross-chunk suffix and the two lane trees
// then exchange points through one (G, 96 B) array in shared memory, a read
// and a write separated by __syncthreads. Complete and unsafe adds are used
// exactly where the JAX package uses them (suffix partials repeat across
// empty buckets).
#include <cuda_runtime.h>

#include "ec.cuh"

#define INTERIOR_THREADS 128
#define SCAN_THREADS 256
#define COMBINE_MAX_G 512

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

// One thread per (row, lane). px/py: (8, n) affine Montgomery SRS words.
// sdig/order: (R, S, K) sorted digits and point indices, lane k holding
// sorted positions [k S, (k + 1) S). Buckets must hold infinity on entry.
__global__ void __launch_bounds__(INTERIOR_THREADS) msm_interior_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py, long long n,
    const int* __restrict__ sdig, const int* __restrict__ order, int R, int S, int K, int nb,
    uint32_t* __restrict__ bx, uint32_t* __restrict__ by, uint32_t* __restrict__ bz,
    uint32_t* __restrict__ fx, uint32_t* __restrict__ fy, uint32_t* __restrict__ fz,
    int* __restrict__ seg, Modulus m, Fe one) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)R * K) return;
  const int r = (int)(tid / K);
  const int k = (int)(tid - (long long)r * K);
  const long long base = (long long)r * S * K + k;
  const long long b_ls = (long long)R * nb;
  const long long f_ls = (long long)R * 2 * K;
  const long long slot = (long long)r * 2 * K + 2 * k;

  int cur = sdig[base];
  long long idx = order[base];
  Pt acc;
  acc.x = fe_load(px, n, idx);
  acc.y = fe_load(py, n, idx);
  acc.z = one;
  bool has_first = false;
  for (int t = 1; t < S; ++t) {
    const int d = sdig[base + (long long)t * K];
    idx = order[base + (long long)t * K];
    const Fe qx = fe_load(px, n, idx);
    const Fe qy = fe_load(py, n, idx);
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

// One block per row: segmented inclusive Hillis-Steele scan of M fragments,
// out[i] = add_unsafe(src[i - d], src[i]) where seg[i - d] == seg[i]. Pass j
// writes `out` when (passes - 1 - j) is even and `tmp` otherwise, so the
// last pass lands in `out`.
__global__ void __launch_bounds__(SCAN_THREADS) msm_scan_kernel(
    const uint32_t* ix, const uint32_t* iy, const uint32_t* iz, uint32_t* ox, uint32_t* oy,
    uint32_t* oz, uint32_t* tx, uint32_t* ty, uint32_t* tz, const int* __restrict__ seg, int M,
    long long ls, int passes, Modulus m) {
  const long long row = (long long)blockIdx.x * M;
  const int* s = seg + row;
  const uint32_t *sx = ix, *sy = iy, *sz = iz;
  if (passes == 0) {
    for (int i = threadIdx.x; i < M; i += blockDim.x)
      pt_store(ox, oy, oz, ls, row + i, pt_load(ix, iy, iz, ls, row + i));
    return;
  }
  for (int j = 0, d = 1; j < passes; ++j, d <<= 1) {
    const bool to_out = ((passes - 1 - j) & 1) == 0;
    uint32_t* dx = to_out ? ox : tx;
    uint32_t* dy = to_out ? oy : ty;
    uint32_t* dz = to_out ? oz : tz;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      Pt v = pt_load(sx, sy, sz, ls, row + i);
      if (i >= d && s[i - d] == s[i]) v = ec_add_unsafe(pt_load(sx, sy, sz, ls, row + i - d), v, m);
      pt_store(dx, dy, dz, ls, row + i, v);
    }
    __syncthreads();
    sx = dx;
    sy = dy;
    sz = dz;
  }
}

__device__ __forceinline__ void sm_store(uint32_t* sm, int G, int g, const Pt& p) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    sm[i * G + g] = p.x.w[i];
    sm[(NW + i) * G + g] = p.y.w[i];
    sm[(2 * NW + i) * G + g] = p.z.w[i];
  }
}

__device__ __forceinline__ Pt sm_load(const uint32_t* sm, int G, int g) {
  Pt p;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    p.x.w[i] = sm[i * G + g];
    p.y.w[i] = sm[(NW + i) * G + g];
    p.z.w[i] = sm[(2 * NW + i) * G + g];
  }
  return p;
}

// One block of G threads per row; buckets (8, R * nb), nb = m G, bucket
// g m + i of row r at element r * nb + g m + i. Writes the row's
// sum_b b * B_b to element r of out (8, R).
__global__ void __launch_bounds__(COMBINE_MAX_G) msm_combine_kernel(
    const uint32_t* __restrict__ bx, const uint32_t* __restrict__ by,
    const uint32_t* __restrict__ bz, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, int R, int nb, int m, Modulus mod, Fe one) {
  extern __shared__ uint32_t sm[];  // [3][8][G] words
  const int G = blockDim.x;
  const int g = threadIdx.x;
  const int r = blockIdx.x;
  const long long ls = (long long)R * nb;
  const long long base = (long long)r * nb + (long long)g * m;

  // 1) within the chunk, from the top: run = sum_{i' >= i} B_i' (unsafe),
  //    W = sum_{i >= 1} run_i (complete)
  Pt run = pt_load(bx, by, bz, ls, base + m - 1);
  Pt w = run;
  for (int i = m - 2; i >= 1; --i) {
    run = ec_add_unsafe(run, pt_load(bx, by, bz, ls, base + i), mod);
    w = ec_add(w, run, mod, one);
  }
  if (m > 1) run = ec_add_unsafe(run, pt_load(bx, by, bz, ls, base), mod);
  if (m == 1) w = pt_infinity(one);

  // 2) cross-chunk inclusive suffix of the chunk totals (unsafe)
  Pt e = run;
  for (int d = 1; d < G; d <<= 1) {
    sm_store(sm, G, g, e);
    __syncthreads();
    if (g < G - d) e = ec_add_unsafe(e, sm_load(sm, G, g + d), mod);
    __syncthreads();
  }
  // X = sum_{g >= 1} E'_g: a tree of complete adds into lane 0
  Pt x = g == 0 ? pt_infinity(one) : e;
  for (int d = G >> 1; d >= 1; d >>= 1) {
    sm_store(sm, G, g, x);
    __syncthreads();
    if (g < d) x = ec_add(x, sm_load(sm, G, g + d), mod, one);
    __syncthreads();
  }
  // Y = sum_g W_g: a tree of unsafe adds into lane 0
  Pt y = w;
  for (int d = G >> 1; d >= 1; d >>= 1) {
    sm_store(sm, G, g, y);
    __syncthreads();
    if (g < d) y = ec_add_unsafe(y, sm_load(sm, G, g + d), mod);
    __syncthreads();
  }
  // 3) m X + Y in lane 0 (m a power of two: log2 m doublings)
  if (g == 0) {
    for (int s = m; s > 1; s >>= 1) x = ec_double(x, mod);
    pt_store(ox, oy, oz, R, r, ec_add(x, y, mod, one));
  }
}

extern "C" int wh2_msm_interior(const void* px, const void* py, long long n, const void* sdig,
                                const void* order, int R, int S, int K, int nb, void* bx,
                                void* by, void* bz, void* fx, void* fy, void* fz, void* seg,
                                const uint32_t* p_words, uint32_t n0, const uint32_t* one_words,
                                void* stream) {
  const long long threads = (long long)R * K;
  const long long blocks = (threads + INTERIOR_THREADS - 1) / INTERIOR_THREADS;
  msm_interior_kernel<<<(unsigned)blocks, INTERIOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, n, (const int*)sdig, (const int*)order, R, S, K,
      nb, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz, (uint32_t*)fx, (uint32_t*)fy,
      (uint32_t*)fz, (int*)seg, make_modulus(p_words, n0), make_fe(one_words));
  return (int)cudaGetLastError();
}

extern "C" int wh2_msm_scan(const void* ix, const void* iy, const void* iz, void* ox, void* oy,
                            void* oz, void* tx, void* ty, void* tz, const void* seg, int R, int M,
                            const uint32_t* p_words, uint32_t n0, void* stream) {
  int passes = 0;
  while ((1 << passes) < M) ++passes;
  msm_scan_kernel<<<(unsigned)R, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ix, (const uint32_t*)iy, (const uint32_t*)iz, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz,
      (const int*)seg, M, (long long)R * M, passes, make_modulus(p_words, n0));
  return (int)cudaGetLastError();
}

extern "C" int wh2_msm_combine(const void* bx, const void* by, const void* bz, void* ox,
                               void* oy, void* oz, int R, int nb, int G,
                               const uint32_t* p_words, uint32_t n0, const uint32_t* one_words,
                               void* stream) {
  if (G < 1 || G > COMBINE_MAX_G || nb % G) return (int)cudaErrorInvalidValue;
  const int smem = 3 * NW * G * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(msm_combine_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  msm_combine_kernel<<<(unsigned)R, G, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, R, nb, nb / G, make_modulus(p_words, n0),
      make_fe(one_words));
  return (int)cudaGetLastError();
}
