// Montgomery multiply through int8 tensor-core products over bn254 Fr or
// Fq: out = a * b * 2^-256 mod p in [0, p), the words of montmul.cu.
//
// Replaces the TPU kernel webauthn_halo2_tpu/ops/mxu_mod.py _pallas_fn (the
// pipeline _pipeline_rows, entry mxu_montmul_rows): the same steps, with
// the constants redone for the port's 32 byte-limbs and R = 2^256 (see
// ops/mxu_mod.py, which builds the matrices, asserts their bounds and holds
// the plain version): EVAL (64 x 256), the pointwise product mod two
// 14-bit primes, INTERP (128 x 128 per prime), CRT, FOLD (256 x 64) and
// the carries. Every contraction is mma.sync m16n8k32 s8 x s8 -> s32 in
// this kernel's own body; no library product is called.
//
// What bounds it on an H100: a multiply is 80,136 int8 multiply-adds
// (81,920 with the tiles' padding) on 96 bytes, so operations: 2 x 80,136
// over 1,979 T int8 ops/s is 0.042 ms at 2^19 elements, against 0.015 ms
// of bytes. Between the products every element also needs some 10,000
// 32-bit operations of digit splitting, mod-q reductions, the pointwise
// products, the CRT and the carries, which this simple kernel does on the
// integer pipes.
//
// Design: a block of MXU_WARPS warps keeps the three matrices in shared
// memory, stored (width, depth) with rows padded by 16 bytes so a
// fragment load of eight rows falls in distinct banks. A warp owns 16
// elements at a time (one m16 tile) and walks them through the pipeline:
//   1. EVAL: the A fragments come straight from the operands' words (a
//      32-bit word holds four byte-limbs in fragment order; & 0x7F7F7F7F
//      and (>> 7) & 0x01010101 give the two digit planes); the point
//      columns are interleaved with their two digits, so each thread holds
//      both digits of its point for rows g and g + 8 of a and of b and
//      finishes the pointwise product in registers;
//   2. the products' digit planes go to a per-warp A tile in shared
//      memory; INTERP runs both primes for the same columns, so the CRT
//      is in registers too; its planes go to a second A tile;
//   3. FOLD gives the 32 limb sums (two nibble columns each) of every row
//      into shared memory, and 16 lanes each carry one row into nine
//      words, subtract q' p (q' from the top 64 bits) and reduce once.
// Blocks are persistent (one per SM; the matrices and tiles take 143 KB of
// shared memory) and stride over the tiles.
#include <cuda_runtime.h>

#include "field.cuh"

#define MXU_WARPS 8
#define MXU_Q1 16381u
#define MXU_Q2 16369u
// row strides in bytes of the shared copies and tiles: depth + 16
#define SE (64 + 16)
#define SI (128 + 16)
#define SF (256 + 16)
#define SO 33  // int32 limb sums per row of the tail's tile
#define EV_BYTES (256 * SE)
#define IV_BYTES (2 * 128 * SI)
#define FOLD_BYTES (64 * SF)
#define TILE_A_BYTES (2 * 16 * SI)  // also holds the (16, SO) int32 limb sums
#define TILE_F_BYTES (16 * SF)
#define WARP_BYTES (TILE_A_BYTES + TILE_F_BYTES)
#define SMEM_BYTES (EV_BYTES + IV_BYTES + FOLD_BYTES + MXU_WARPS * WARP_BYTES)

// D += A B for one m16n8k32 tile: A row-major 16 x 32, B column-major
// 32 x 8, s8 operands, s32 accumulators.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of k-step ks from a row-major int8 tile (row stride in bytes):
// registers hold rows g, g + 8, g, g + 8 at depths 4t.. and 16 + 4t..
__device__ __forceinline__ void load_a(uint32_t a[4], const int8_t* tile, int stride, int ks,
                                       int g, int t) {
  const int8_t* r0 = tile + g * stride + ks * 32 + 4 * t;
  const int8_t* r1 = r0 + 8 * stride;
  a[0] = *(const uint32_t*)r0;
  a[1] = *(const uint32_t*)r1;
  a[2] = *(const uint32_t*)(r0 + 16);
  a[3] = *(const uint32_t*)(r1 + 16);
}

// B fragment of n-tile nt and k-step ks from a (width, depth) int8 matrix:
// column nt * 8 + g at depths 4t.. and 16 + 4t..
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const int8_t* mat, int stride,
                                       int nt, int ks, int g, int t) {
  const int8_t* c = mat + (nt * 8 + g) * stride + ks * 32 + 4 * t;
  b0 = *(const uint32_t*)c;
  b1 = *(const uint32_t*)(c + 16);
}

// a b 2^-16 mod q for a, b in [0, q): a b + m q < 2^28 + 2^30.
__device__ __forceinline__ uint32_t pointwise(uint32_t a, uint32_t b, uint32_t q, uint32_t qinv) {
  const uint32_t prod = a * b;
  const uint32_t m = ((prod & 0xFFFFu) * qinv) & 0xFFFFu;
  const uint32_t t = (prod + m * q) >> 16;
  return t >= q ? t - q : t;
}

__device__ __forceinline__ void copy_rows(int8_t* dst, int stride, const uint32_t* src, int rows,
                                          int depth) {
  const int wpr = depth / 4;
  for (int i = threadIdx.x; i < rows * wpr; i += blockDim.x) {
    const int r = i / wpr;
    *(uint32_t*)(dst + r * stride + 4 * (i - r * wpr)) = src[i];
  }
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* x, long long M, int w,
                                                 long long e) {
  return e < M ? x[w * M + e] : 0u;
}

__global__ void __launch_bounds__(MXU_WARPS * 32) mxu_montmul_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
    long long M, const uint32_t* __restrict__ ev, const uint32_t* __restrict__ iv,
    const uint32_t* __restrict__ fold, Modulus mod, uint32_t qinv1, uint32_t qinv2,
    uint32_t inv12, unsigned long long pt1) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* s_ev = smem;
  int8_t* s_iv = s_ev + EV_BYTES;
  int8_t* s_fold = s_iv + IV_BYTES;
  copy_rows(s_ev, SE, ev, 256, 64);
  copy_rows(s_iv, SI, iv, 256, 128);
  copy_rows(s_fold, SF, fold, 64, 256);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int8_t* tile_a = s_fold + FOLD_BYTES + warp * WARP_BYTES;
  int8_t* tile_f = tile_a + TILE_A_BYTES;
  int* sums = (int*)tile_a;
  const long long tiles = (M + 15) / 16;

  for (long long tile = (long long)blockIdx.x * MXU_WARPS + warp; tile < tiles;
       tile += (long long)gridDim.x * MXU_WARPS) {
    const long long e0 = tile * 16;

    // 1. EVAL and the pointwise product
    uint32_t fa[2][4], fb[2][4];
    {
      const uint32_t wa[4] = {word_or_zero(a, M, t, e0 + g), word_or_zero(a, M, t, e0 + g + 8),
                              word_or_zero(a, M, t + 4, e0 + g),
                              word_or_zero(a, M, t + 4, e0 + g + 8)};
      const uint32_t wb[4] = {word_or_zero(b, M, t, e0 + g), word_or_zero(b, M, t, e0 + g + 8),
                              word_or_zero(b, M, t + 4, e0 + g),
                              word_or_zero(b, M, t + 4, e0 + g + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fa[0][i] = wa[i] & 0x7F7F7F7Fu;
        fa[1][i] = (wa[i] >> 7) & 0x01010101u;
        fb[0][i] = wb[i] & 0x7F7F7F7Fu;
        fb[1][i] = (wb[i] >> 7) & 0x01010101u;
      }
    }
#pragma unroll
    for (int P = 0; P < 2; ++P) {
      const uint32_t q = P ? MXU_Q2 : MXU_Q1;
      const uint32_t qinv = P ? qinv2 : qinv1;
      int8_t* rows = tile_a + P * 16 * SI;
#pragma unroll 1
      for (int j = 0; j < 16; ++j) {
        const int nt = P * 16 + j;
        int ca[4] = {0, 0, 0, 0}, cb[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t b0, b1;
          load_b(b0, b1, s_ev, SE, nt, ks, g, t);
          mma_s8(ca, fa[ks], b0, b1);
          mma_s8(cb, fb[ks], b0, b1);
        }
        // the two digits recombine to sum_i plane_i * (residue): >= 0
        const uint32_t c_lo = pointwise((uint32_t)(ca[0] + 256 * ca[1]) % q,
                                        (uint32_t)(cb[0] + 256 * cb[1]) % q, q, qinv);
        const uint32_t c_hi = pointwise((uint32_t)(ca[2] + 256 * ca[3]) % q,
                                        (uint32_t)(cb[2] + 256 * cb[3]) % q, q, qinv);
        const int u = 4 * j + t;
        rows[g * SI + u] = (int8_t)(c_lo & 127);
        rows[g * SI + 64 + u] = (int8_t)(c_lo >> 7);
        rows[(g + 8) * SI + u] = (int8_t)(c_hi & 127);
        rows[(g + 8) * SI + 64 + u] = (int8_t)(c_hi >> 7);
      }
    }
    __syncwarp();

    // 2. INTERP for both primes, then the CRT
    uint32_t fi[2][4][4];
#pragma unroll
    for (int P = 0; P < 2; ++P)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) load_a(fi[P][ks], tile_a + P * 16 * SI, SI, ks, g, t);
#pragma unroll 1
    for (int nt = 0; nt < 16; ++nt) {
      int c1[4] = {0, 0, 0, 0}, c2[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t b0, b1;
        load_b(b0, b1, s_iv, SI, nt, ks, g, t);
        mma_s8(c1, fi[0][ks], b0, b1);
        load_b(b0, b1, s_iv + 128 * SI, SI, nt, ks, g, t);
        mma_s8(c2, fi[1][ks], b0, b1);
      }
      const int tt = 4 * nt + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t r1 = (uint32_t)(c1[2 * h] + 256 * c1[2 * h + 1]) % MXU_Q1;
        const uint32_t r2 = (uint32_t)(c2[2 * h] + 256 * c2[2 * h + 1]) % MXU_Q2;
        const uint32_t s = ((r2 + 2 * MXU_Q2 - r1) * inv12) % MXU_Q2;
        int8_t* row = tile_f + (g + 8 * h) * SF;
        row[tt] = (int8_t)(r1 & 127);
        row[64 + tt] = (int8_t)(r1 >> 7);
        row[128 + tt] = (int8_t)(s & 127);
        row[192 + tt] = (int8_t)(s >> 7);
      }
    }
    __syncwarp();

    // 3. FOLD: limb sums o_l = N_2l + 16 N_2l+1 of rows g and g + 8
    uint32_t ff[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) load_a(ff[ks], tile_f, SF, ks, g, t);
#pragma unroll 1
    for (int nt = 0; nt < 8; ++nt) {
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t b0, b1;
        load_b(b0, b1, s_fold, SF, nt, ks, g, t);
        mma_s8(c, ff[ks], b0, b1);
      }
      const int l = 4 * nt + t;
      sums[g * SO + l] = c[0] + 16 * c[1];
      sums[(g + 8) * SO + l] = c[2] + 16 * c[3];
    }
    __syncwarp();

    // 4. the tail: lane r carries row r into nine words V < 2^269, takes
    //    q' = floor((V >> 206) / pt1), subtracts q' p and reduces once
    if (lane < 16 && e0 + lane < M) {
      const int* o = sums + lane * SO;
      uint64_t v[NW + 1];
      uint64_t c = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t x = (uint64_t)o[4 * w] + ((uint64_t)o[4 * w + 1] << 8) +
                           ((uint64_t)o[4 * w + 2] << 16) + ((uint64_t)o[4 * w + 3] << 24) + c;
        v[w] = x & 0xFFFFFFFFull;
        c = x >> 32;
      }
      v[NW] = c;
      const uint64_t qh = ((v[8] << 50) | (v[7] << 18) | (v[6] >> 14)) / pt1;
      Fe d;
      uint64_t mc = 0;
      int64_t br = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t pm = qh * mod.p[w] + mc;
        mc = pm >> 32;
        const int64_t x = (int64_t)v[w] - (int64_t)(pm & 0xFFFFFFFFull) - br;
        br = x < 0;
        d.w[w] = (uint32_t)x;
      }
      const Fe r = fe_reduce_once(d, mod);
      const long long e = e0 + lane;
#pragma unroll
      for (int w = 0; w < NW; ++w) out[w * M + e] = r.w[w];
    }
    __syncwarp();
  }
}

// One m16n8k32 tile, for checking the fragment layouts against a host
// product: A (16, 32) row-major, B (8, 32) = B^T row-major, C (16, 8).
__global__ void mma_tile_kernel(const int8_t* A, const int8_t* B, int* C) {
  const int g = threadIdx.x >> 2;
  const int t = threadIdx.x & 3;
  uint32_t a[4], b0, b1;
  load_a(a, A, 32, 0, g, t);
  load_b(b0, b1, B, 32, 0, 0, g, t);
  int c[4] = {0, 0, 0, 0};
  mma_s8(c, a, b0, b1);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}

extern "C" int wh2_mxu_montmul(const void* a, const void* b, void* out, long long M,
                               const void* ev, const void* iv, const void* fold,
                               const uint32_t* p_words, uint32_t qinv1, uint32_t qinv2,
                               uint32_t inv12, unsigned long long pt1, void* stream) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = 0;
  cudaError_t err = cudaFuncSetAttribute(mxu_montmul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = (M + 15) / 16;
  long long blocks = (tiles + MXU_WARPS - 1) / MXU_WARPS;
  if (blocks > sms) blocks = sms;
  if (blocks < 1) blocks = 1;
  mxu_montmul_kernel<<<(unsigned)blocks, MXU_WARPS * 32, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, M, (const uint32_t*)ev,
      (const uint32_t*)iv, (const uint32_t*)fold, m, qinv1, qinv2, inv12, pt1);
  return (int)cudaGetLastError();
}

extern "C" int wh2_mma_tile(const void* A, const void* B, void* C, void* stream) {
  mma_tile_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int8_t*)A, (const int8_t*)B,
                                                     (int*)C);
  return (int)cudaGetLastError();
}
