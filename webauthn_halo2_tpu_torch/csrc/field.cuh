// Shared __device__ core for a prime field below 2^254 (bn254 Fr and Fq).
//
// An element is eight little-endian 32-bit words. Tensors are word-major,
// (8, *batch): word i of element e sits at  base[i * limb_stride + e].
// Montgomery R = 2^256. Every function here takes operands in [0, p) and
// returns a result in [0, p): the port keeps values fully reduced, so the
// host side never needs a normalisation pass.
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

// t - p if t >= p, else t. t < 2p < 2^255, so t fits in eight words.
__device__ __forceinline__ Fe fe_reduce_once(const Fe& t, const Modulus& m) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)t.w[i] - m.p[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  return borrow ? t : d;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const Modulus& m) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)v;
    carry = v >> 32;
  }
  return fe_reduce_once(s, m);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const Modulus& m) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t v = (uint64_t)d.w[i] + m.p[i] + carry;
      d.w[i] = (uint32_t)v;
      carry = v >> 32;
    }
  }
  return d;
}

// CIOS Montgomery multiply: a * b * 2^-256 mod p. With a, b < p < 2^254 the
// running sum stays below 2p, so nine words (t[8] for the top carry) suffice.
__device__ __forceinline__ Fe fe_montmul(const Fe& a, const Fe& b, const Modulus& m) {
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
// in [0, p), so the words equal fe_montmul(a, a, m).
__device__ __forceinline__ Fe fe_sqr(const Fe& a, const Modulus& m) {
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
