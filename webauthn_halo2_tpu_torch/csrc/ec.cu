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
// in, three out) and, when both operands are finite, does 12 Montgomery
// multiplies of 256 32-bit multiply-adds and 4 squares of 200, 3,872 in
// all: 13 multiply-adds a byte, about three times the card's 5, so
// operations, not bytes. An add with an infinite operand is a copy.
//
// Design: one thread per element of the flattened batch, ec_add_unsafe of
// ec.cuh (the formula and select order of the plain version, so the words
// agree), its add core compiled inline (EC_BODY), so that the points stay
// in registers where a call passed them through a stack frame, on the
// carry-chain multiply with its four squares. Word-major loads coalesce
// across a warp; no padding: the grid-stride loop masks the ragged tail
// that the TPU padded to 512. An add is a chain of dependent multiplies,
// so what sets its time is how many warps an SM holds to hide their
// latency: this body takes 100 registers, two blocks of 256 an SM. The
// 64-bit C multiply ran 11% faster held to 128 registers but spilled, and
// slower at its own 160 (three blocks of 128, or one of 256 or 384); a
// warp that queued the finite sums and copied the others ran slower still
// (PERF.md).
#include <cuda_runtime.h>

#define EC_BODY __forceinline__
#include "ec.cuh"

#define EC_ADD_THREADS 256

__global__ void __launch_bounds__(EC_ADD_THREADS) ec_add_unsafe_kernel(
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
  const int threads = EC_ADD_THREADS;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  ec_add_unsafe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n,
      m);
  return (int)cudaGetLastError();
}
