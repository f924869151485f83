// Batched Montgomery multiply over bn254 Fr or Fq: out = a * b * 2^-256 mod p.
//
// Replaces the TPU kernel webauthn_halo2_tpu/ops/pallas_kernels.py
// montmul_pallas (_montmul_kernel / _montmul_body / _carry_round_body): a
// 33-limb, 8-bit CIOS on (33, n) int32 blocks of 512 lanes, output lazy < 2p.
//
// What bounds it on an H100: one element moves 96 bytes (two 32-byte
// inputs, one 32-byte output) and does 128 word products, 256 32-bit
// multiply-adds (low and high halves). At 3.35 TB/s against about
// 16.75 T multiply-adds/s the bytes are the bound on paper (2.7 multiply-
// adds per byte, under the card's 5), but the carry chains and the final
// subtract issue on the same integer pipe, which probably sets the time
// (not measured).
//
// Design: one thread per element, all eight words of a and b in registers,
// the nine-word CIOS accumulator in registers, full reduction into [0, p).
// Loads are word-major: word i of neighbouring elements is contiguous, so a
// warp's load of word i is one coalesced 128-byte transaction. Either
// operand may be a broadcast scalar (stride 0 across the batch) and may
// have its own limb stride, so slices of a stacked (8, B, n) tensor and
// (8, 1) constants need no copy. The ragged tail is masked by the bounds
// check of a grid-stride loop.
#include <cuda_runtime.h>

#include "field.cuh"

__global__ void __launch_bounds__(256) montmul_kernel(
    const uint32_t* __restrict__ a, long long a_ls, int a_bc,
    const uint32_t* __restrict__ b, long long b_ls, int b_bc,
    uint32_t* __restrict__ out, long long n, Modulus m) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    Fe x = fe_load(a, a_ls, a_bc ? 0 : e);
    Fe y = fe_load(b, b_ls, b_bc ? 0 : e);
    fe_store(out, n, e, fe_montmul(x, y, m));
  }
}

extern "C" int wh2_montmul(const void* a, long long a_ls, int a_bc,
                           const void* b, long long b_ls, int b_bc, void* out,
                           long long n, const uint32_t* p_words, uint32_t n0,
                           void* stream) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = n0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  montmul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, a_ls, a_bc, (const uint32_t*)b, b_ls, b_bc,
      (uint32_t*)out, n, m);
  return (int)cudaGetLastError();
}
