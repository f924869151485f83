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
// is bound by the multiply-adds.
//
// Stage A design: one block per (polynomial, tile of T = 2^log_t elements).
// The TPU tile of 8192 elements is 256 KB at 32 bytes each, more than the
// 227 KB a block may use, so T is at most 4096 (128 KB of dynamic shared
// memory, above the 48 KB default, set with cudaFuncSetAttribute). The tile
// is stored word-major in shared memory ([8][T]), so neighbouring threads hit
// neighbouring banks. Each stage gives every thread T / 2 / blockDim
// disjoint butterflies; __syncthreads() separates the stages. Exact field
// arithmetic makes the result independent of T.
//
// Stage B design: one thread per butterfly pair. It reads lo and hi once and
// writes both outputs, so a stage moves each element through memory once
// (the TPU's one-output-block form reads every input twice: once as lo and
// once as hi). Consecutive threads take consecutive pairs, so all loads and
// stores coalesce.
#include <cuda_runtime.h>

#include "field.cuh"

#define STAGE_A_THREADS 512

__global__ void __launch_bounds__(STAGE_A_THREADS) ntt_stage_a_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tw, long long tw_ls, long long n,
    long long ls, int log_t, Modulus m) {
  extern __shared__ uint32_t sm[];
  const int T = 1 << log_t;
  const long long base = (long long)blockIdx.y * n + (long long)blockIdx.x * T;
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NW; ++i) sm[i * T + e] = x[i * ls + base + e];
  }
  __syncthreads();
  for (int s = 0; s < log_t; ++s) {
    const int h = 1 << s;
    for (int q = threadIdx.x; q < (T >> 1); q += blockDim.x) {
      const int j = q & (h - 1);
      const int lo = ((q >> s) << (s + 1)) + j;
      const int hi = lo + h;
      Fe w = fe_load(tw, tw_ls, (long long)(h - 1 + j));
      Fe a, b;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        a.w[i] = sm[i * T + lo];
        b.w[i] = sm[i * T + hi];
      }
      Fe t = fe_montmul(w, b, m);
      Fe u = fe_add(a, t, m);
      Fe v = fe_sub(a, t, m);
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        sm[i * T + lo] = u.w[i];
        sm[i * T + hi] = v.w[i];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
#pragma unroll
    for (int i = 0; i < NW; ++i) out[i * ls + base + e] = sm[i * T + e];
  }
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

// x, out: (8, batch, n) contiguous; runs stages h = 1 .. 2^(log_t - 1).
extern "C" int wh2_ntt_stage_a(const void* x, void* out, const void* tw,
                               long long tw_ls, long long batch, long long n,
                               int log_t, const uint32_t* p_words, uint32_t n0,
                               void* stream) {
  const int T = 1 << log_t;
  const size_t smem = (size_t)NW * T * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_stage_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(n / T), (unsigned)batch);
  ntt_stage_a_kernel<<<grid, STAGE_A_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, tw_ls, n,
      batch * n, log_t, make_modulus(p_words, n0));
  return (int)cudaGetLastError();
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
