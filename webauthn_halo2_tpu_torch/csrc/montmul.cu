// Batched Montgomery multiply over bn254 Fr or Fq: out = a * b * 2^-256 mod p.
//
// Replaces the TPU kernel webauthn_halo2_tpu/ops/pallas_kernels.py
// montmul_pallas (_montmul_kernel / _montmul_body / _carry_round_body): a
// 33-limb, 8-bit CIOS on (33, n) int32 blocks of 512 lanes, output lazy < 2p.
//
// What bounds it on an H100: one element moves 96 bytes (two 32-byte
// inputs, one 32-byte output) and does 128 word products, 256 32-bit
// multiply-adds (low and high halves). At 3.35 TB/s against about
// 16.75 T multiply-adds/s that is 2.7 multiply-adds a byte, under the
// card's 5, so the bytes bound it. Launched back to back (from a CUDA
// graph) it runs close to that bound at (8, 2^19), the multiply body
// hardly mattering; launched one at a time from Python, as the prover
// does, the host's cost of a launch is longer than the kernel (PERF.md).
//
// Design: the multiply is field.cuh's carry-chain PTX (a word product half
// or a carry an instruction). One thread per element: word i of a warp's
// 32 neighbouring elements is one coalesced load. Loads are word-major and
// the nine-word CIOS accumulator stays in registers. Whether an operand is
// a broadcast scalar (stride 0 across the batch, as an (8, 1) constant) is
// a template parameter, not a test per element; each operand may have its
// own limb stride, so slices of a stacked (8, B, n) tensor need no copy.
// Indices are 32-bit where every index fits. The ragged tail is masked by
// the bounds check of a grid-stride loop. Two and four neighbouring
// elements a thread (8- and 16-byte loads) measured slower at (8, 2^19)
// (PERF.md), the kernel being near its byte bound already.
#include <cuda_runtime.h>

#include "field.cuh"

#define MONTMUL_THREADS 256

// word i of element e (or of the one element, broadcast)
template <bool BC, typename Idx>
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ base, Idx ls, Idx e,
                                              int i) {
  if constexpr (BC) return __ldg(base + i * ls);
  return __ldg(base + i * ls + e);
}

template <bool ABC, bool BBC, typename Idx>
__global__ void __launch_bounds__(MONTMUL_THREADS) montmul_kernel(
    const uint32_t* __restrict__ a, Idx a_ls, const uint32_t* __restrict__ b, Idx b_ls,
    uint32_t* __restrict__ out, Idx n, Modulus m) {
  const Idx step = (Idx)gridDim.x * MONTMUL_THREADS;
  for (Idx e = (Idx)blockIdx.x * MONTMUL_THREADS + threadIdx.x; e < n; e += step) {
    Fe x, y;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      x.w[i] = load_word<ABC>(a, a_ls, e, i);
      y.w[i] = load_word<BBC>(b, b_ls, e, i);
    }
    x = fe_montmul(x, y, m);
#pragma unroll
    for (int i = 0; i < NW; ++i) out[i * n + e] = x.w[i];
  }
}

template <typename Idx>
static int launch(const void* a, long long a_ls, int a_bc, const void* b, long long b_ls,
                  int b_bc, void* out, long long n, const Modulus& m, cudaStream_t s) {
  long long blocks = (n + MONTMUL_THREADS - 1) / MONTMUL_THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  const unsigned g = (unsigned)blocks;
  if (a_bc && b_bc)
    montmul_kernel<true, true, Idx><<<g, MONTMUL_THREADS, 0, s>>>(pa, (Idx)a_ls, pb, (Idx)b_ls, po, (Idx)n, m);
  else if (a_bc)
    montmul_kernel<true, false, Idx><<<g, MONTMUL_THREADS, 0, s>>>(pa, (Idx)a_ls, pb, (Idx)b_ls, po, (Idx)n, m);
  else if (b_bc)
    montmul_kernel<false, true, Idx><<<g, MONTMUL_THREADS, 0, s>>>(pa, (Idx)a_ls, pb, (Idx)b_ls, po, (Idx)n, m);
  else
    montmul_kernel<false, false, Idx><<<g, MONTMUL_THREADS, 0, s>>>(pa, (Idx)a_ls, pb, (Idx)b_ls, po, (Idx)n, m);
  return (int)cudaGetLastError();
}

extern "C" int wh2_montmul(const void* a, long long a_ls, int a_bc,
                           const void* b, long long b_ls, int b_bc, void* out,
                           long long n, const uint32_t* p_words, uint32_t n0,
                           void* stream) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = n0;
  cudaStream_t s = (cudaStream_t)stream;
  // the largest index any operand reaches, + one grid step of slack
  long long top = n + 65535LL * 16 * MONTMUL_THREADS;
  if (!a_bc) top = top > (NW - 1) * a_ls + n ? top : (NW - 1) * a_ls + n;
  if (!b_bc) top = top > (NW - 1) * b_ls + n ? top : (NW - 1) * b_ls + n;
  top += (NW - 1) * n;
  if (top < (1LL << 31)) return launch<int>(a, a_ls, a_bc, b, b_ls, b_bc, out, n, m, s);
  return launch<long long>(a, a_ls, a_bc, b, b_ls, b_bc, out, n, m, s);
}
