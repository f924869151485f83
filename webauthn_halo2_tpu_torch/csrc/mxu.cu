// Montgomery multiply through int8 tensor-core products over bn254 Fr or
// Fq: out = a * b * 2^-256 mod p in [0, p), the words of montmul.cu.
//
// Replaces the TPU kernel webauthn_halo2_tpu/ops/mxu_mod.py _pallas_fn (the
// pipeline _pipeline_rows, entry mxu_montmul_rows): the same steps, with
// the constants redone for the port's 32 byte-limbs and R = 2^256 (see
// ops/mxu_mod.py, which builds the matrices in the order this kernel reads
// them, asserts their bounds and holds the plain version): EVAL (32 x 256)
// at the points 0, +-1, ..., +-31, the pointwise product mod two 14-bit
// primes, INTERP (64 x 64 for each prime and parity of the product
// polynomial), CRT, FOLD (256 x 32) and the carries. Every contraction is
// mma.sync m16n8k32 u8 x u8 -> s32 in this kernel's own body; no library
// product is called.
//
// What bounds it on an H100: a multiply is 40,072 int8 multiply-adds on 96
// bytes, 0.021 ms at 2^19 elements over 1,979 T int8 ops/s, against 0.015
// ms of bytes; more is the 32-bit work around the products that any int8
// route does (ops/mxu_mod.GLUE_OPS, some 1,400 instructions an element:
// 0.022 ms at the SMs' issue rate), and this design adds some 760
// (mxu_mod.DESIGN_OPS). On the card an mma.sync does not overlap the other
// instructions of its SM sub-partition (their times add), and high and
// wide multiplies issue at a quarter and a sixth of the SMs' issue rate
// (PERF.md section 6). So the design keeps the products few, that work to
// few, single instructions, and every value in registers:
//   1. a warp owns MXU_MT m16 tiles (16 elements each) at a time; the
//      operands' words are EVAL's A fragments as they are (word t of
//      element g is limbs 4t..4t+3 of row g), no digit split;
//   2. EVAL's accumulator pair of a point gives E; the pointwise product
//      (a shift-fold, a 64-bit product and a Montgomery step) gives C <
//      2^15; one fragment load brings a thread's +u and -u columns, and
//      C(u) + C(-u), C(u) - C(-u) + 2q (the even and odd parts of the
//      product polynomial, at u^2) are packed by byte permutes, four u to
//      a register, into the INTERP A registers of the same thread (the
//      matrices' rows are ordered for it: mxu_mod.interp_row);
//   3. INTERP runs both primes for an even and an odd n-tile, the CRT
//      follows in registers (exact reductions by a multiply with
//      ceil(2^45/q)), and the r1 and s bytes of the four coefficients make
//      one FOLD A register set (mxu_mod.fold_row), consumed at once:
//      FOLD's accumulators build up across INTERP's loop;
//   4. FOLD's columns leave thread t with limbs 8t..8t+7 of its rows; it
//      sums them into two 64-bit word parts, and one lane a row (all 32
//      lanes: a warp's 32 elements) carries the nine words through shared
//      memory, takes q' = umulhi(V >> 238, floor(2^270/p)), subtracts q' p
//      and reduces once.
// The matrices sit in shared memory as m16n8k32 B fragments, two to a
// 16-byte load per lane (mxu_mod.kernel_image): 32 KB a block. Blocks of
// MXU_WARPS warps, MXU_MIN_BLOCKS an SM, are persistent and stride over the
// warps' tiles (the fastest of 1-2 tiles a warp and 8-24 warps an SM).
#include <cuda_runtime.h>

#include "field.cuh"

#define MXU_MT 2  // m16 tiles a warp takes at once: 32 elements, one a lane in the tail
#define MXU_WARPS 4  // warps a block
#define MXU_MIN_BLOCKS 3  // blocks an SM: 12 warps at up to 168 registers
#define MXU_Q1 16381u
#define MXU_Q2 16369u
#define ROWS (16 * MXU_MT)
static_assert(ROWS <= 32, "the tail takes one row a lane");
// rows of 32 uint4 (one a lane) of the fragment image: EVAL's 32 n-tiles,
// INTERP's 8 n-tiles x 2 parities x 2 primes x 2 k-steps, FOLD's 8 k-steps
// x 4 n-tiles
#define EV_ROWS 16
#define IV_ROWS 32
#define FOLD_ROWS 16
#define IMAGE_U4 ((EV_ROWS + IV_ROWS + FOLD_ROWS) * 32)
#define PART_U4 5  // uint4 a row of the tail's word parts: 4 threads + 1 of padding
#define SMEM_BYTES (IMAGE_U4 * 16 + MXU_WARPS * ROWS * PART_U4 * 16)

struct MxuScalars {
  uint32_t qinv[2];     // q^-1 mod 2^32
  uint32_t barrett[2];  // ceil(2^45 / q)
  uint32_t ninv12;      // -(q1^-1 mod q2) mod 2^32
  uint32_t q12;         // q1 q2
  uint32_t tail_m;      // floor(2^270 / p)
};

// D += A B for one m16n8k32 tile: A row-major 16 x 32, B column-major
// 32 x 8, u8 operands, s32 accumulators.
__device__ __forceinline__ void mma_u8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x mod q for x < 2^31: m = ceil(2^45 / q) (mxu_mod.consts asserts it exact)
__device__ __forceinline__ uint32_t mod_exact(uint32_t x, uint32_t q, uint32_t m) {
  return x - q * (__umulhi(x, m) >> 13);
}

// ea eb 2^-32 mod q in [1, q + 2^13), for ea, eb < 2^27: ea is folded
// once below 2^17.1 by 2^14 = q + d, the 64-bit product lies below 2^44.1,
// m = lo q^-1 mod 2^32, and (prod - m q) / 2^32 = hi - umulhi(m, q).
__device__ __forceinline__ uint32_t pointwise(uint32_t ea, uint32_t eb, uint32_t q,
                                              uint32_t qinv) {
  const uint64_t prod = (uint64_t)((ea & 16383u) + (16384u - q) * (ea >> 14)) * eb;
  const uint32_t m = (uint32_t)prod * qinv;
  return (uint32_t)(prod >> 32) + q - __umulhi(m, q);
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* x, long long M, int w,
                                                 long long e) {
  return e < M ? x[w * M + e] : 0u;
}

__global__ void __launch_bounds__(MXU_WARPS * 32, MXU_MIN_BLOCKS) mxu_montmul_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
    long long M, const uint4* __restrict__ image, Modulus mod, MxuScalars sc) {
  extern __shared__ __align__(16) uint4 smem[];
  for (int i = threadIdx.x; i < IMAGE_U4; i += blockDim.x) smem[i] = image[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint4* s_ev = smem + lane;
  const uint4* s_iv = s_ev + EV_ROWS * 32;
  const uint4* s_fold = s_iv + IV_ROWS * 32;
  uint4* part = smem + IMAGE_U4 + warp * ROWS * PART_U4;
  const long long iters = (M + ROWS - 1) / ROWS;

  for (long long it = (long long)blockIdx.x * MXU_WARPS + warp; it < iters;
       it += (long long)gridDim.x * MXU_WARPS) {
    const long long e0 = it * ROWS;

    // EVAL's A fragments: words t and t + 4 of rows g and g + 8
    uint32_t fa[MXU_MT][4], fb[MXU_MT][4];
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m) {
      const long long r0 = e0 + 16 * m + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = t + 4 * (i >> 1);
        const long long r = r0 + 8 * (i & 1);
        fa[m][i] = word_or_zero(a, M, w, r);
        fb[m][i] = word_or_zero(b, M, w, r);
      }
    }

    // 1. EVAL at +u and -u and the pointwise products, their sum S and
    //    difference D packed into INTERP's A registers: xa[P][par][k][m] for
    //    S (par 0) and D (par 1) at k-step k, byte j of register r (row
    //    g + 8 (r & 1), byte r >> 1) from u = 16k + 4j + t
    uint32_t xa[2][2][2][MXU_MT][4];
#pragma unroll
    for (int P = 0; P < 2; ++P) {
      const uint32_t q = P ? MXU_Q2 : MXU_Q1;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint32_t sd[2][4][MXU_MT][2];  // S and D of the four u
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 bf = s_ev[(P * 8 + k * 4 + j) * 32];  // +u: x, y; -u: z, w
#pragma unroll
          for (int m = 0; m < MXU_MT; ++m) {
            int ap[4] = {0, 0, 0, 0}, bp[4] = {0, 0, 0, 0};
            int am[4] = {0, 0, 0, 0}, bm[4] = {0, 0, 0, 0};
            mma_u8(ap, fa[m], bf.x, bf.y);
            mma_u8(bp, fb[m], bf.x, bf.y);
            mma_u8(am, fa[m], bf.z, bf.w);
            mma_u8(bm, fb[m], bf.z, bf.w);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t cp =
                  pointwise((uint32_t)ap[2 * r] + 256u * (uint32_t)ap[2 * r + 1],
                            (uint32_t)bp[2 * r] + 256u * (uint32_t)bp[2 * r + 1], q, sc.qinv[P]);
              const uint32_t cm =
                  pointwise((uint32_t)am[2 * r] + 256u * (uint32_t)am[2 * r + 1],
                            (uint32_t)bm[2 * r] + 256u * (uint32_t)bm[2 * r + 1], q, sc.qinv[P]);
              sd[0][j][m][r] = cp + cm;
              sd[1][j][m][r] = cp - cm + 2 * q;
            }
          }
        }
#pragma unroll
        for (int par = 0; par < 2; ++par)
#pragma unroll
          for (int m = 0; m < MXU_MT; ++m)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t lo = __byte_perm(sd[par][0][m][r], sd[par][1][m][r], 0x5410);
              const uint32_t hi = __byte_perm(sd[par][2][m][r], sd[par][3][m][r], 0x5410);
              xa[P][par][k][m][r] = __byte_perm(lo, hi, 0x6420);
              xa[P][par][k][m][2 + r] = __byte_perm(lo, hi, 0x7531);
            }
      }
    }

    // 2. INTERP's even and odd n-tile k for both primes, the CRT, and FOLD's
    //    k-step k from their coefficients 8k + 2t (par 0) and 8k + 2t + 1
    int fo[4][MXU_MT][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int m = 0; m < MXU_MT; ++m) fo[n][m][0] = fo[n][m][1] = fo[n][m][2] = fo[n][m][3] = 0;
#pragma unroll 2
    for (int k = 0; k < 8; ++k) {
      uint32_t y[2][MXU_MT][2];  // r1 | s << 16, rows g and g + 8
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const uint4 f1 = s_iv[((k * 2 + par) * 2) * 32];  // prime 1, k-steps 0 and 1
        const uint4 f2 = s_iv[((k * 2 + par) * 2 + 1) * 32];
#pragma unroll
        for (int m = 0; m < MXU_MT; ++m) {
          int x1[4] = {0, 0, 0, 0};
          int x2[4] = {(int)sc.q12, 0, (int)sc.q12, 0};
          mma_u8(x1, xa[0][par][0][m], f1.x, f1.y);
          mma_u8(x2, xa[1][par][0][m], f2.x, f2.y);
          mma_u8(x1, xa[0][par][1][m], f1.z, f1.w);
          mma_u8(x2, xa[1][par][1][m], f2.z, f2.w);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t r1 = mod_exact((uint32_t)x1[2 * r] + 256u * (uint32_t)x1[2 * r + 1],
                                          MXU_Q1, sc.barrett[0]);
            const uint32_t s = mod_exact(
                (uint32_t)x2[2 * r] + 256u * (uint32_t)x2[2 * r + 1] + r1 * sc.ninv12, MXU_Q2,
                sc.barrett[1]);
            y[par][m][r] = __byte_perm(r1, s, 0x5410);
          }
        }
      }
      const uint4 f0 = s_fold[(2 * k) * 32];
      const uint4 f1 = s_fold[(2 * k + 1) * 32];
#pragma unroll
      for (int m = 0; m < MXU_MT; ++m) {
        const uint32_t fa2[4] = {__byte_perm(y[0][m][0], y[1][m][0], 0x6240),
                                 __byte_perm(y[0][m][1], y[1][m][1], 0x6240),
                                 __byte_perm(y[0][m][0], y[1][m][0], 0x7351),
                                 __byte_perm(y[0][m][1], y[1][m][1], 0x7351)};
        mma_u8(fo[0][m], fa2, f0.x, f0.y);
        mma_u8(fo[1][m], fa2, f0.z, f0.w);
        mma_u8(fo[2][m], fa2, f1.x, f1.y);
        mma_u8(fo[3][m], fa2, f1.z, f1.w);
      }
    }

    // 3. thread t's limbs 8t + 2n + h (fo[n][m][2r + h], row g + 8r) as two
    //    64-bit word parts X (limbs 8t..8t+3) and Y, into the row's slot t
#pragma unroll
    for (int m = 0; m < MXU_MT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint64_t X = (uint64_t)(uint32_t)fo[0][m][2 * r] +
                           ((uint64_t)(uint32_t)fo[0][m][2 * r + 1] << 8) +
                           ((uint64_t)(uint32_t)fo[1][m][2 * r] << 16) +
                           ((uint64_t)(uint32_t)fo[1][m][2 * r + 1] << 24);
        const uint64_t Y = (uint64_t)(uint32_t)fo[2][m][2 * r] +
                           ((uint64_t)(uint32_t)fo[2][m][2 * r + 1] << 8) +
                           ((uint64_t)(uint32_t)fo[3][m][2 * r] << 16) +
                           ((uint64_t)(uint32_t)fo[3][m][2 * r + 1] << 24);
        part[(16 * m + g + 8 * r) * PART_U4 + t] =
            make_uint4((uint32_t)X, (uint32_t)(X >> 32), (uint32_t)Y, (uint32_t)(Y >> 32));
      }
    __syncwarp();

    // 4. the tail, lane r on row r: nine words V < 2^270, q' = floor((V >>
    //    238) floor(2^270 / p) / 2^32), V - q' p in [0, 2p), reduce once
    const long long e = e0 + lane;
    if (lane < ROWS && e < M) {
      uint32_t v[NW + 1];
      uint64_t c = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint4 x = part[lane * PART_U4 + s];
        c += ((uint64_t)x.y << 32) | x.x;
        v[2 * s] = (uint32_t)c;
        c = (c >> 32) + (((uint64_t)x.w << 32) | x.z);
        v[2 * s + 1] = (uint32_t)c;
        c >>= 32;
      }
      v[NW] = (uint32_t)c;
      const uint32_t qh = __umulhi(__funnelshift_l(v[7], v[8], 18), sc.tail_m);
      Fe d;
      uint64_t mc = 0;
      int64_t br = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t pm = (uint64_t)qh * mod.p[w] + mc;
        mc = pm >> 32;
        const int64_t x = (int64_t)v[w] - (int64_t)(pm & 0xFFFFFFFFull) - br;
        br = x < 0;
        d.w[w] = (uint32_t)x;
      }
      const Fe res = fe_reduce_once(d, mod);
#pragma unroll
      for (int w = 0; w < NW; ++w) out[w * M + e] = res.w[w];
    }
    __syncwarp();
  }
}

// One m16n8k32 u8 tile with the kernel's instruction, for checking the
// fragment maps against a host product: A (16, 32) row-major, B (8, 32) =
// B^T row-major, C (16, 8). Lane (g, t) reads A bytes 4t.. and 16 + 4t.. of
// rows g and g + 8 and B^T row g at the same depths, and holds C columns 2t
// and 2t + 1 of rows g and g + 8.
__global__ void mma_tile_kernel(const uint8_t* A, const uint8_t* B, int* C) {
  const int g = threadIdx.x >> 2;
  const int t = threadIdx.x & 3;
  const uint32_t a[4] = {*(const uint32_t*)(A + g * 32 + 4 * t),
                         *(const uint32_t*)(A + (g + 8) * 32 + 4 * t),
                         *(const uint32_t*)(A + g * 32 + 16 + 4 * t),
                         *(const uint32_t*)(A + (g + 8) * 32 + 16 + 4 * t)};
  int c[4] = {0, 0, 0, 0};
  mma_u8(c, a, *(const uint32_t*)(B + g * 32 + 4 * t), *(const uint32_t*)(B + g * 32 + 16 + 4 * t));
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}

extern "C" int wh2_mxu_montmul(const void* a, const void* b, void* out, long long M,
                               const void* image, const uint32_t* p_words,
                               const uint32_t* scalars, void* stream) {
  Modulus m;
  for (int i = 0; i < NW; ++i) m.p[i] = p_words[i];
  m.n0 = 0;
  MxuScalars sc;
  sc.qinv[0] = scalars[0];
  sc.qinv[1] = scalars[1];
  sc.barrett[0] = scalars[2];
  sc.barrett[1] = scalars[3];
  sc.ninv12 = scalars[4];
  sc.q12 = scalars[5];
  sc.tail_m = scalars[6];
  cudaError_t err = cudaFuncSetAttribute(mxu_montmul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mxu_montmul_kernel,
                                                           MXU_WARPS * 32, SMEM_BYTES)) !=
      cudaSuccess)
    return (int)err;
  const long long iters = (M + ROWS - 1) / ROWS;
  long long blocks = (iters + MXU_WARPS - 1) / MXU_WARPS;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  mxu_montmul_kernel<<<(unsigned)blocks, MXU_WARPS * 32, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, M, (const uint4*)image, m, sc);
  return (int)cudaGetLastError();
}

extern "C" int wh2_mma_tile(const void* A, const void* B, void* C, void* stream) {
  mma_tile_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint8_t*)A, (const uint8_t*)B,
                                                     (int*)C);
  return (int)cudaGetLastError();
}
