// Shared __device__ core for a prime field below 2^254 (bn254 Fr and Fq).
//
// An element is eight little-endian 32-bit words. Tensors are word-major,
// (8, *batch): word i of element e sits at  base[i * limb_stride + e].
// Montgomery R = 2^256. Every function here takes operands in [0, p) and
// returns a result in [0, p): the port keeps values fully reduced, so the
// host side never needs a normalisation pass, and a result has one set of
// words whatever the order of the arithmetic that made it.
//
// The arithmetic is written as carry chains in inline PTX: mad.lo.cc /
// madc.hi.cc / addc.cc and sub.cc / subc.cc, each word product and each
// carry one instruction, where 64-bit C arithmetic costs a wide multiply
// and a 64-bit add chain a word. Each instruction is its own `asm
// volatile` statement, which keeps a chain's instructions in order; the
// carry passes from one statement to the next through the PTX condition
// code, which the PTX manual describes only for straight-line
// extended-precision sequences. nvcc for sm_90a keeps it (in SASS a carry
// predicate read by IADD3.X), as in the usual GPU big-integer code, but no
// document promises that: correctness rests on chip_smoke.py's
// word-for-word checks of every kernel against its plain version, on edge
// words (0, 1, p - 1, R mod p, words just below p) and random words in Fr
// and Fq, which are the gate whenever the CUDA toolchain changes.
#pragma once
#include <cstdint>

#define NW 8

struct Modulus {
  uint32_t p[NW];
  uint32_t n0;  // -p^-1 mod 2^32
};

struct Fe {
  uint32_t w[NW];
};

__device__ __forceinline__ Fe fe_load(const uint32_t* base, long long limb_stride, long long e) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = base[i * limb_stride + e];
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* base, long long limb_stride, long long e, const Fe& v) {
#pragma unroll
  for (int i = 0; i < NW; ++i) base[i * limb_stride + e] = v.w[i];
}

// --- carry-chain primitives -------------------------------------------
// .cc writes the carry flag, a `c` op reads it.

#define WH2_PTX2(name, op)                                                     \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {           \
    uint32_t r;                                                                \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                \
    return r;                                                                  \
  }
#define WH2_PTX3(name, op)                                                     \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t r;                                                                \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));    \
    return r;                                                                  \
  }
WH2_PTX2(add_cc, "add.cc.u32")
WH2_PTX2(addc_cc, "addc.cc.u32")
WH2_PTX2(addc, "addc.u32")
WH2_PTX2(sub_cc, "sub.cc.u32")
WH2_PTX2(subc_cc, "subc.cc.u32")
WH2_PTX2(subc, "subc.u32")
WH2_PTX3(mad_lo_cc, "mad.lo.cc.u32")
WH2_PTX3(madc_lo_cc, "madc.lo.cc.u32")
WH2_PTX3(mad_hi_cc, "mad.hi.cc.u32")
WH2_PTX3(madc_hi_cc, "madc.hi.cc.u32")
WH2_PTX3(madc_hi, "madc.hi.u32")
#undef WH2_PTX2
#undef WH2_PTX3

// t - p if t >= p, else t. t < 2p < 2^255, so t fits in eight words.
__device__ __forceinline__ Fe fe_reduce_once(const Fe& t, const Modulus& m) {
  Fe d;
  d.w[0] = sub_cc(t.w[0], m.p[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) d.w[i] = subc_cc(t.w[i], m.p[i]);
  const uint32_t borrow = subc(0, 0);  // all ones when t < p
#pragma unroll
  for (int i = 0; i < NW; ++i) d.w[i] = borrow ? t.w[i] : d.w[i];
  return d;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const Modulus& m) {
  Fe s;  // a + b < 2p < 2^255: no carry leaves word 7
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) s.w[i] = addc_cc(a.w[i], b.w[i]);
  return fe_reduce_once(s, m);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const Modulus& m) {
  Fe d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) d.w[i] = subc_cc(a.w[i], b.w[i]);
  const uint32_t borrow = subc(0, 0);  // all ones when a < b: add p back
  d.w[0] = add_cc(d.w[0], m.p[0] & borrow);
#pragma unroll
  for (int i = 1; i < NW; ++i) d.w[i] = addc_cc(d.w[i], m.p[i] & borrow);
  return d;
}

// t[0..8] += a * b: the low halves of the eight word products in one
// chain, the high halves in another, one word up. The caller keeps the sum
// below 2^288, so no carry leaves t[8].
__device__ __forceinline__ void fe_mac_row(uint32_t* t, const uint32_t* a, uint32_t b) {
  t[0] = mad_lo_cc(a[0], b, t[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(a[j], b, t[j]);
  t[NW] = addc(t[NW], 0);
  t[1] = mad_hi_cc(a[0], b, t[1]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j + 1] = madc_hi_cc(a[j], b, t[j + 1]);
  t[NW] = madc_hi(a[NW - 1], b, t[NW]);
}

// CIOS Montgomery multiply: a * b * 2^-256 mod p. Round i adds a * b_i and
// m_i * p (m_i = t_0 * n0 clears word 0) and drops word 0. With a, b < p <
// 2^254 the running sum stays below 2p after each round and below 2^288
// within it, so nine words hold it: 34 multiply-adds and a multiply a round.
__device__ __forceinline__ Fe fe_montmul(const Fe& a, const Fe& b, const Modulus& m) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    fe_mac_row(t, a.w, b.w[i]);
    fe_mac_row(t, m.p, t[0] * m.n0);  // t[0] is now 0
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
    t[NW] = 0;
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[i];
  return fe_reduce_once(r, m);
}

// Montgomery square: a * a * 2^-256 mod p. The 28 cross products a_i a_j
// (i < j) are computed once and doubled, the 8 squares added, then eight
// reduction rounds run on the 16-word product (separated operand
// scanning): 100 word products against the CIOS multiply's 128. Both land
// in [0, p), so the words equal fe_montmul(a, a, m).
__device__ __forceinline__ Fe fe_sqr(const Fe& a, const Modulus& m) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
  // row i adds a_i a_j (j > i) at word i + j; the rows so far sum to less
  // than 2^(32 (i + 9)), so row i's last carry stays in word i + 8
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    t[2 * i + 1] = mad_lo_cc(a.w[i], a.w[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < NW; ++j) t[i + j] = madc_lo_cc(a.w[i], a.w[j], t[i + j]);
    t[i + NW] = addc(t[i + NW], 0);
    t[2 * i + 2] = mad_hi_cc(a.w[i], a.w[i + 1], t[2 * i + 2]);
#pragma unroll
    for (int j = i + 2; j < NW; ++j) t[i + j + 1] = madc_hi_cc(a.w[i], a.w[j], t[i + j + 1]);
  }
  // twice the cross sum (below a^2 < 2^508, so no bit leaves word 15),
  // then the squares a_i^2 at word 2i
  t[0] = add_cc(t[0], t[0]);
#pragma unroll
  for (int i = 1; i < 2 * NW; ++i) t[i] = addc_cc(t[i], t[i]);
  t[0] = mad_lo_cc(a.w[0], a.w[0], t[0]);
  t[1] = madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    t[2 * i] = madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  // reduction: round i clears word i; hc (at most 2) carries into word
  // i + NW + 1. a^2 + M p < p^2 + 2^256 p < 2^512, so the last carry is 0
  // and the result, the top eight words, is below 2p.
  uint32_t hc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t mq = t[i] * m.n0;
    t[i] = mad_lo_cc(mq, m.p[0], t[i]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[i + j] = madc_lo_cc(mq, m.p[j], t[i + j]);
    t[i + NW] = addc_cc(t[i + NW], hc);
    hc = addc(0, 0);
    t[i + 1] = mad_hi_cc(mq, m.p[0], t[i + 1]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[i + j + 1] = madc_hi_cc(mq, m.p[j], t[i + j + 1]);
    hc = addc(hc, 0);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[NW + i];
  return fe_reduce_once(r, m);
}

// The multiply and the square in 64-bit C arithmetic (a wide multiply and
// a 64-bit add a word product), the same words as fe_montmul and fe_sqr. The compiler computes their products
// ahead of the adds that take them, where a PTX carry chain puts each
// multiply on the chain. The combine's EC adds (csrc/combine.cu), chains
// of dependent adds with few warps to hide them, and NTT stage A
// (csrc/ntt.cu) ran faster on these; the other kernels ran faster on the
// PTX ones (PERF.md).
//
// CIOS Montgomery multiply: a * b * 2^-256 mod p. With a, b < p < 2^254 the
// running sum stays below 2p, so nine words (t[8] for the top carry) suffice.
__device__ __forceinline__ Fe fe_montmul_c64(const Fe& a, const Fe& b, const Modulus& m) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t v = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    uint64_t v = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)v;
    t[NW + 1] = (uint32_t)(v >> 32);
    uint32_t mq = t[0] * m.n0;
    v = (uint64_t)mq * m.p[0] + t[0];
    c = v >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      v = (uint64_t)mq * m.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)v;
      c = v >> 32;
    }
    v = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)v;
    t[NW] = t[NW + 1] + (uint32_t)(v >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[i];
  return fe_reduce_once(r, m);
}

// Montgomery square: a * a * 2^-256 mod p. The 28 cross products a_i a_j
// (i < j) are computed once and doubled, the 8 squares a_i^2 added, then
// eight reduction rounds run on the 16-word product (separated operand
// scanning): 100 word products against the CIOS multiply's 128. Both land
// in [0, p), so the words equal fe_montmul_c64(a, a, m).
__device__ __forceinline__ Fe fe_sqr_c64(const Fe& a, const Modulus& m) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      uint64_t v = (uint64_t)a.w[i] * a.w[j] + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = v >> 32;
    }
    t[i + NW] = (uint32_t)c;
  }
  // twice the cross sum (below a^2 < 2^508, so no bit leaves word 15)
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) {
    const uint32_t w = t[i];
    t[i] = (w << 1) | top;
    top = w >> 31;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] * a.w[i] + t[2 * i] + c;
    t[2 * i] = (uint32_t)v;
    v = (uint64_t)t[2 * i + 1] + (v >> 32);
    t[2 * i + 1] = (uint32_t)v;
    c = v >> 32;
  }
  // reduction: round i clears word i; hc carries into word i + NW + 1.
  // a^2 + M p < p^2 + 2^256 p < 2^512, so the last carry is 0 and the
  // result, the top eight words, is below 2p.
  uint32_t hc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t mq = t[i] * m.n0;
    c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t v = (uint64_t)mq * m.p[j] + t[i + j] + c;
      t[i + j] = (uint32_t)v;
      c = v >> 32;
    }
    const uint64_t v = (uint64_t)t[i + NW] + c + hc;
    t[i + NW] = (uint32_t)v;
    hc = (uint32_t)(v >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[NW + i];
  return fe_reduce_once(r, m);
}
