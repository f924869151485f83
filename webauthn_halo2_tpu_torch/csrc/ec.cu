// Fused infinity-aware Jacobian add over bn254 G1: out = p + q for p, q
// finite and distinct up to sign, or either at infinity.
//
// Replaces the TPU kernel webauthn_halo2_tpu/ops/pallas_kernels.py
// ec_add_unsafe_pallas (_ec_add_unsafe_kernel): 16 field multiplies and
// six subtractions on (33, 512) int32 blocks of lazy limbs, then selects
// for an infinite operand. Driven by ops/ec.py `add_unsafe_fast`, which is
// every point add of the serial Pippenger (ops/msm.py: its run growth and
// its segmented boundary scan) and so of the v1 driver's boundary scan.
//
// What bounds it on an H100: an element moves 288 bytes (six coordinates
// in, three out) and does 16 Montgomery multiplies of 256 32-bit
// multiply-adds, 4,096 in all: 14 multiply-adds a byte, about three times
// the card's 5, so operations, not bytes (about 0.09 ms against 0.03 ms
// of bytes at 368,640 elements).
//
// Design: one thread per element of the flattened batch, ec_add_unsafe of
// ec.cuh (the formula and select order of the plain version, so the words
// agree), word-major loads that coalesce across a warp. No padding: the
// grid-stride loop masks the ragged tail that the TPU padded to 512.
#include <cuda_runtime.h>

#include "ec.cuh"

__global__ void __launch_bounds__(256) ec_add_unsafe_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
    const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3, uint32_t* __restrict__ z3,
    long long n, Modulus m) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const Pt p = pt_load(x1, y1, z1, n, e);
    const Pt q = pt_load(x2, y2, z2, n, e);
    pt_store(x3, y3, z3, n, e, ec_add_unsafe(p, q, m));
  }
}

extern "C" int wh2_ec_add_unsafe(const void* x1, const void* y1, const void* z1,
                                 const void* x2, const void* y2, const void* z2, void* x3,
                                 void* y3, void* z3, long long n, const uint32_t* p_words,
                                 uint32_t n0, void* stream) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = n0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  ec_add_unsafe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
      m);
  return (int)cudaGetLastError();
}
