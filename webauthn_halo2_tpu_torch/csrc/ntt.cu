// Radix-2 decimation-in-time NTT stages over bn254 Fr, on bit-reversed input.
//
// Replaces the TPU kernels of webauthn_halo2_tpu/ops/ntt_pallas.py:
//   * stage A (_stage_a / _kernel_a): every block-local stage (pair distance
//     h < T) in one pass per VMEM-resident block of T = 8192 lanes;
//   * stage B (_stage_b / _kernel_b): one cross-block stage (h >= T) per
//     launch, each grid step writing one output block from its lo and hi
//     partner blocks.
//
// Layout: x is (8, B, n) word-major, so word i of element j of polynomial b
// sits at x[i * B * n + b * n + j]. Twiddles are one flat (8, n - 1) table:
// stage s (h = 2^s) uses entries [h - 1, 2h - 1), entry h - 1 + j holding
// w_{2h}^j in Montgomery form. These are the compact per-stage tables of
// ops/ntt._stage_twiddles laid end to end; the TPU's pre-tiled
// (stages, L, T) pattern tensor only worked around a Mosaic reshape limit.
//
// What bounds them on an H100: a butterfly is one Montgomery multiply
// (256 32-bit multiply-adds) plus an add and a subtract, and moves two
// 32-byte elements in and two out when its stage goes through device
// memory: 2 multiply-adds per byte, under the card's 5. Stage B does just
// that, so it is bound by the bytes. Stage A keeps a tile in shared memory
// through its log2(T) stages, reading and writing each element once, so it
// is bound by the multiply-adds. A butterfly whose twiddle is w^0 = 1 (one
// in 2^s of stage s) needs none: the least work counts the others.
//
// Stage A design: one block per (polynomial, tile of T = 2^log_t elements),
// T at most 4096 (128 KB of dynamic shared memory, above the 48 KB default,
// set with cudaFuncSetAttribute). Each of the block's T / 4 threads holds
// four elements in registers and runs the tile's stages two at a time
// (radix 4): a pass with window c gives thread g the elements
//   elem(g, k) = ((g >> c) << (c + 2)) | (k << c) | (g mod 2^c),  k < 4,
// which are closed under the butterflies of stages c and c + 1, so the
// thread runs them alone; passes start at s = 0, 2, 4, ... with
// c = min(s, log_t - 2), and the last pass runs only the stages its window
// has left (ops/ntt.stage_a_passes says the same in Python). Between
// passes the elements go through the shared tile once, with one
// __syncthreads(): half the barriers and trips of one stage a pass. The
// first pass reads its four consecutive elements straight from device
// memory (one 16-byte load a word), the last pass writes straight back
// (for each k, consecutive threads hit consecutive words). The tile is two
// planes of 16-byte slots (words 0-3, words 4-7) at slot e ^ ((e >> 3) & 7):
// eight threads of a quarter warp then touch eight distinct slots mod 8, so
// a 16-byte access is free of bank conflicts in the passes with c = 0 or
// c >= 3. A stage's twiddle depends on k's bits below the stage's bit only,
// so a pass loads three twiddles, not one a butterfly; in the first pass
// (c = 0) the twiddle of k's low bits 0 is w^0 = 1, whose Montgomery
// product is the element itself, so three of its four butterflies need no
// multiply. The multiply is field.cuh's 64-bit C body.
//
// Blocks of a cluster (sm_90's thread-block clusters, 2^cq blocks) then
// run the stages above their tiles as one tile of 2^(log_t + cq): each
// such stage pairs a tile with the one 2^q ranks away, slot for slot, and
// each block of the pair takes half of the butterflies, reading both tiles
// through distributed shared memory. A launch thus covers more stages than
// one block's 128 KB allows, while its blocks stay small enough that two
// or more share an SM: with one block an SM, the whole SM waits at each
// barrier.
//
// ops/ntt.stage_a_schedule picks blocks of 2^10 in clusters of 2 for every
// shape of the proof. Measured on an H100 (scripts/sweep_torch_kernels.py,
// PERF.md): radix 8 (eight elements a thread, 128 registers) ran slower at
// every shape than radix 4 (64 registers), blocks of 4096 elements slower
// a stage than blocks of 2048 or 1024, and clusters of 4 slower than of 2;
// a single column of 2^17 with this schedule has 128 blocks for the 132
// SMs, where tiles of 4096 gave it 32. Exact field arithmetic makes the
// result independent of the schedule.
//
// Stage B design: one thread per butterfly pair. It reads lo and hi once and
// writes both outputs, so a stage moves each element through memory once
// (the TPU's one-output-block form reads every input twice: once as lo and
// once as hi). Consecutive threads take consecutive pairs, so all loads and
// stores coalesce.
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "field.cuh"

namespace cg = cooperative_groups;

// Radix 2^R passes: each thread holds E = 4 elements (R = 2), at most 64
// registers a thread, so a block of up to 1024 threads holds a 4096-element
// tile.
#define STAGE_A_R 2
#define STAGE_A_E (1 << STAGE_A_R)
#define STAGE_A_MAX_THREADS 1024

// The shared tile's slot of element e (a bijection on [0, T) for T >= 8).
__device__ __forceinline__ int tile_slot(int e) { return e ^ ((e >> 3) & 7); }

__device__ __forceinline__ void tile_put(uint4* sm, int T, int e, const Fe& v) {
  const int p = tile_slot(e);
  sm[p] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  sm[T + p] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

__device__ __forceinline__ Fe tile_get(const uint4* sm, int T, int e) {
  const int p = tile_slot(e);
  const uint4 a = sm[p];
  const uint4 b = sm[T + p];
  Fe v;
  v.w[0] = a.x;
  v.w[1] = a.y;
  v.w[2] = a.z;
  v.w[3] = a.w;
  v.w[4] = b.x;
  v.w[5] = b.y;
  v.w[6] = b.z;
  v.w[7] = b.w;
  return v;
}

__device__ __forceinline__ int pass_elem(int g, int c, int k) {
  return ((g >> c) << (c + STAGE_A_R)) | (k << c) | (g & ((1 << c) - 1));
}

// One butterfly: (a, b) <- (a + w b, a - w b). The 64-bit C multiply: it
// ran stage A 1-4% faster than the carry-chain one (PERF.md).
__device__ __forceinline__ void butterfly(Fe& a, Fe& b, const Fe& w, const Modulus& m) {
  const Fe t = fe_montmul_c64(w, b, m);
  b = fe_sub(a, t, m);
  a = fe_add(a, t, m);
}

// Stages [s, e) of the pass with window c on the thread's elements v[k].
// Stage st = c + b pairs k with k | 2^b (bit b of k clear); the pair's
// twiddle is entry 2^st - 1 + j of the table, j = elem(g, k) mod 2^st =
// (k mod 2^b) << c | (g mod 2^c). FIRST: the pass with c = 0, where j = 0
// (k mod 2^b = 0) needs no multiply.
template <bool FIRST>
__device__ __forceinline__ void pass_stages(Fe (&v)[STAGE_A_E], const uint32_t* __restrict__ tw,
                                            long long tw_ls, int g, int c, int s, int e,
                                            const Modulus& m) {
#pragma unroll
  for (int b = 0; b < STAGE_A_R; ++b) {
    const int st = c + b;
    if (st < s || st >= e) continue;
#pragma unroll
    for (int kl = 0; kl < (1 << b); ++kl) {
      const bool one = FIRST && kl == 0;
      Fe w;
      if (!one) w = fe_load(tw, tw_ls, (long long)((1 << st) - 1 + ((kl << c) | (g & ((1 << c) - 1)))));
#pragma unroll
      for (int kh = 0; kh < (STAGE_A_E >> (b + 1)); ++kh) {
        const int lo = (kh << (b + 1)) | kl;
        const int hi = lo | (1 << b);
        if (one) {
          const Fe t = v[hi];
          v[hi] = fe_sub(v[lo], t, m);
          v[lo] = fe_add(v[lo], t, m);
        } else {
          butterfly(v[lo], v[hi], w, m);
        }
      }
    }
  }
}

// x, out: (8, B, n) word-major, ls = B n. Block (tile, polynomial) of T / 4
// threads over a tile of T = 2^log_t elements, 2 T 16-byte slots of
// dynamic shared memory. Launched in clusters of 2^cq blocks (cq >= 1),
// the cluster's 2^cq tiles then run stages log_t .. log_t + cq - 1 too,
// as one tile of 2^(log_t + cq) elements: each of them pairs every element
// of a tile with the same slot of the tile 2^q ranks away; each block of
// such a pair takes half of its butterflies, reading both tiles through
// distributed shared memory.
__global__ void __launch_bounds__(STAGE_A_MAX_THREADS) ntt_stage_a_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tw, long long tw_ls, long long n,
    long long ls, int log_t, int cq, Modulus m) {
  constexpr int R = STAGE_A_R;
  constexpr int E = STAGE_A_E;
  extern __shared__ uint4 sm[];
  const int T = 1 << log_t;
  const int g = threadIdx.x;
  const long long base = (long long)blockIdx.y * n + (long long)blockIdx.x * T;
  Fe v[E];
  // pass 0 (c = 0): elements g E .. g E + E - 1, one 16-byte load a word
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + i * ls + base + ((long long)g << R)));
    v[0].w[i] = u.x;
    v[1].w[i] = u.y;
    v[2].w[i] = u.z;
    v[3].w[i] = u.w;
  }
  pass_stages<true>(v, tw, tw_ls, g, 0, 0, min(R, log_t), m);
  int c = 0;
  for (int s = R; s < log_t; s += R) {
#pragma unroll
    for (int k = 0; k < E; ++k) tile_put(sm, T, pass_elem(g, c, k), v[k]);
    __syncthreads();
    c = min(s, log_t - R);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = tile_get(sm, T, pass_elem(g, c, k));
    pass_stages<false>(v, tw, tw_ls, g, c, s, min(s + R, log_t), m);
  }
  if (cq == 0) {
#pragma unroll
    for (int k = 0; k < E; ++k) fe_store(out, ls, base + pass_elem(g, c, k), v[k]);
    return;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) tile_put(sm, T, pass_elem(g, c, k), v[k]);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long long cbase = base - (long long)r * T;
  for (int q = 0; q < cq; ++q) {
    cluster.sync();
    const int st = log_t + q;
    const int rlo = r & ~(1 << q);
    const int rhi = rlo | (1 << q);
    uint4* slo = cluster.map_shared_rank(sm, rlo);
    uint4* shi = cluster.map_shared_rank(sm, rhi);
    const int e0 = ((r >> q) & 1) * (T >> 1);
    const int jhi = (r & ((1 << q) - 1)) << log_t;
    for (int e = e0 + g; e < e0 + (T >> 1); e += T >> R) {
      Fe a = tile_get(slo, T, e);
      Fe b = tile_get(shi, T, e);
      butterfly(a, b, fe_load(tw, tw_ls, (1LL << st) - 1 + (jhi | e)), m);
      if (q == cq - 1) {
        fe_store(out, ls, cbase + (long long)rlo * T + e, a);
        fe_store(out, ls, cbase + (long long)rhi * T + e, b);
      } else {
        tile_put(slo, T, e, a);
        tile_put(shi, T, e, b);
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

__global__ void __launch_bounds__(256) ntt_stage_b_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tw, long long tw_ls, long long n,
    long long ls, long long pairs, int s, Modulus m) {
  const long long half = n >> 1;
  const long long h = 1LL << s;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < pairs; q += (long long)gridDim.x * blockDim.x) {
    const long long b = q / half;
    const long long qq = q - b * half;
    const long long j = qq & (h - 1);
    const long long lo = b * n + ((qq >> s) << (s + 1)) + j;
    const long long hi = lo + h;
    Fe w = fe_load(tw, tw_ls, h - 1 + j);
    Fe a = fe_load(x, ls, lo);
    Fe c = fe_load(x, ls, hi);
    Fe t = fe_montmul(w, c, m);
    fe_store(out, ls, lo, fe_add(a, t, m));
    fe_store(out, ls, hi, fe_sub(a, t, m));
  }
}

static Modulus make_modulus(const uint32_t* p_words, uint32_t n0) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = n0;
  return m;
}

// x, out: (8, batch, n) contiguous and 16-byte aligned; runs stages
// h = 1 .. 2^(log_t + cq - 1): blocks of 2^(log_t - 2) threads over tiles of
// 2^log_t elements, in clusters of 2^cq blocks.
extern "C" int wh2_ntt_stage_a(const void* x, void* out, const void* tw,
                               long long tw_ls, long long batch, long long n,
                               int log_t, int cq, const uint32_t* p_words,
                               uint32_t n0, void* stream) {
  const int T = 1 << log_t;
  const size_t smem = (size_t)NW * T * sizeof(uint32_t);
  if (log_t < 3 || (T >> STAGE_A_R) > STAGE_A_MAX_THREADS || cq < 0 || cq > 2 ||
      n % ((long long)T << cq))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_stage_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n / T), (unsigned)batch);
  cfg.blockDim = dim3((unsigned)(T >> STAGE_A_R));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1u << cq;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ntt_stage_a_kernel, (const uint32_t*)x, (uint32_t*)out,
                                 (const uint32_t*)tw, tw_ls, n, batch * n, log_t, cq,
                                 make_modulus(p_words, n0));
}

// One stage with pair distance h = 2^s over every polynomial of the batch.
extern "C" int wh2_ntt_stage_b(const void* x, void* out, const void* tw,
                               long long tw_ls, long long batch, long long n,
                               int s, const uint32_t* p_words, uint32_t n0,
                               void* stream) {
  const int threads = 256;
  const long long pairs = batch * (n >> 1);
  long long blocks = (pairs + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  ntt_stage_b_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, tw_ls, n,
      batch * n, pairs, s, make_modulus(p_words, n0));
  return (int)cudaGetLastError();
}
