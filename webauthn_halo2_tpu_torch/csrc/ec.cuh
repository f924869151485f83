// Shared __device__ elliptic-curve bodies over bn254 G1 (a = 0), on top of
// field.cuh.
//
// Counterparts of the TPU bodies of webauthn_halo2_tpu/ops/msm_pallas.py:
//   ec_madd          <- _madd_body          (Jacobian + affine, no degenerate cases)
//   ec_add_unsafe    <- _jadd_unsafe_body   (infinity-aware, not P == +-Q)
//   ec_double        <- _jdouble_body
//   ec_add           <- _jadd_complete_body (infinities, P == Q, P == -Q)
// The TPU keeps lazy 8-bit limbs and needs _lazy_reduce_body, _sub_body and
// a REDC-by-1 _is_zero_body; here every value is fully reduced, so a zero
// test is a compare of eight words and those bodies have no counterpart.
//
// A point is Jacobian (X, Y, Z) in Montgomery form; Z = 0 is infinity, made
// with X = Y = one as ops/ec.py's `infinity` makes it. Each body follows the
// formula and the select order of its plain version in ops/ec.py step for
// step, so kernel and plain version give the same words, not only the same
// affine point.
#pragma once
#include "field.cuh"

// EC_MUL and EC_SQR: the field multiply and square of these bodies,
// field.cuh's carry-chain fe_montmul and fe_sqr unless the including
// source names others before including this header (csrc/combine.cu
// takes the 64-bit C ones, which measured faster there).
#ifndef EC_MUL
#define EC_MUL fe_montmul
#define EC_SQR fe_sqr
#endif

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) o |= a.w[i];
  return o == 0;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const Modulus& m) { return fe_add(a, a, m); }

__device__ __forceinline__ Pt pt_infinity(const Fe& one) {
  Pt r;
  r.x = one;
  r.y = one;
  r.z = fe_zero();
  return r;
}

// Three (8, *batch) word-major coordinate arrays sharing one limb stride.
__device__ __forceinline__ Pt pt_load(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                      long long ls, long long e) {
  Pt r;
  r.x = fe_load(x, ls, e);
  r.y = fe_load(y, ls, e);
  r.z = fe_load(z, ls, e);
  return r;
}

__device__ __forceinline__ void pt_store(uint32_t* x, uint32_t* y, uint32_t* z, long long ls,
                                         long long e, const Pt& p) {
  fe_store(x, ls, e, p.x);
  fe_store(y, ls, e, p.y);
  fe_store(z, ls, e, p.z);
}

// p + (x2, y2) with Z2 = 1; p finite and not +-(x2, y2). The words of
// ops/ec.py `add_unsafe` with Z2 = one, in 11 multiplies instead of 16, three
// of them squares (EC_SQR gives the words of EC_MUL(a, a)).
__device__ __forceinline__ Pt ec_madd(const Pt& p, const Fe& x2, const Fe& y2, const Modulus& m) {
  Fe z1z1 = EC_SQR(p.z, m);
  Fe u2 = EC_MUL(x2, z1z1, m);
  Fe s2 = EC_MUL(y2, EC_MUL(p.z, z1z1, m), m);
  Fe h = fe_sub(u2, p.x, m);
  Fe r = fe_sub(s2, p.y, m);
  Fe hh = EC_SQR(h, m);
  Fe hhh = EC_MUL(h, hh, m);
  Fe v = EC_MUL(p.x, hh, m);
  Pt o;
  o.x = fe_sub(fe_sub(EC_SQR(r, m), hhh, m), fe_dbl(v, m), m);
  o.y = fe_sub(EC_MUL(r, fe_sub(v, o.x, m), m), EC_MUL(p.y, hhh, m), m);
  o.z = EC_MUL(p.z, h, m);
  return o;
}

// EC_BODY: how ec_add_core and ec_double are compiled. Not inlined by
// default: a kernel with many add sites (the scan's three levels) would
// take about a minute to build with their unrolled multiplies at every
// site, and a call passes the points through the stack. A source whose
// kernels have few add sites and need their points in registers (the
// combine, csrc/combine.cu) defines EC_BODY as __forceinline__ before
// including this header.
#ifndef EC_BODY
#define EC_BODY __noinline__
#endif

// The general Jacobian sum without any select; H and R come back for the
// complete add. ops/ec.py `_add_core`: 12 multiplies and 4 squares (EC_SQR
// gives the words of EC_MUL(a, a), a fully reduced product being unique).
__device__ EC_BODY Pt ec_add_core(const Pt& p, const Pt& q, const Modulus& m, Fe& h,
                                       Fe& r) {
  Fe z1z1 = EC_SQR(p.z, m);
  Fe z2z2 = EC_SQR(q.z, m);
  Fe u1 = EC_MUL(p.x, z2z2, m);
  Fe u2 = EC_MUL(q.x, z1z1, m);
  Fe s1 = EC_MUL(p.y, EC_MUL(q.z, z2z2, m), m);
  Fe s2 = EC_MUL(q.y, EC_MUL(p.z, z1z1, m), m);
  h = fe_sub(u2, u1, m);
  r = fe_sub(s2, s1, m);
  Fe hh = EC_SQR(h, m);
  Fe hhh = EC_MUL(h, hh, m);
  Fe v = EC_MUL(u1, hh, m);
  Pt o;
  o.x = fe_sub(fe_sub(EC_SQR(r, m), hhh, m), fe_dbl(v, m), m);
  o.y = fe_sub(EC_MUL(r, fe_sub(v, o.x, m), m), EC_MUL(s1, hhh, m), m);
  o.z = EC_MUL(EC_MUL(p.z, q.z, m), h, m);
  return o;
}

// Infinity-aware, NOT for P == +-Q. ops/ec.py `add_unsafe`: an infinite p
// gives q, then an infinite q gives p.
__device__ __forceinline__ Pt ec_add_unsafe(const Pt& p, const Pt& q, const Modulus& m) {
  if (fe_is_zero(q.z)) return p;
  if (fe_is_zero(p.z)) return q;
  Fe h, r;
  return ec_add_core(p, q, m, h, r);
}

// a = 0 doubling; stays at infinity for Z = 0 (X, Y then are whatever the
// formula gives, as in ops/ec.py `double`).
__device__ EC_BODY Pt ec_double(const Pt& p, const Modulus& m) {
  Fe a = EC_MUL(p.x, p.x, m);
  Fe b = EC_MUL(p.y, p.y, m);
  Fe c = EC_MUL(b, b, m);
  Fe xb = fe_add(p.x, b, m);
  Fe t = EC_MUL(xb, xb, m);
  Fe d = fe_dbl(fe_sub(fe_sub(t, a, m), c, m), m);
  Fe e = fe_add(fe_dbl(a, m), a, m);
  Fe f = EC_MUL(e, e, m);
  Fe c8 = fe_dbl(fe_dbl(fe_dbl(c, m), m), m);
  Pt o;
  o.x = fe_sub(f, fe_dbl(d, m), m);
  o.y = fe_sub(EC_MUL(e, fe_sub(d, o.x, m), m), c8, m);
  o.z = EC_MUL(fe_dbl(p.y, m), p.z, m);
  return o;
}

// Complete add. ops/ec.py `add`: P == Q doubles, P == -Q gives infinity,
// then an infinite p gives q and an infinite q gives p (so inf + inf = p).
__device__ __forceinline__ Pt ec_add(const Pt& p, const Pt& q, const Modulus& m, const Fe& one) {
  if (fe_is_zero(q.z)) return p;
  if (fe_is_zero(p.z)) return q;
  Fe h, r;
  Pt o = ec_add_core(p, q, m, h, r);
  if (fe_is_zero(h)) return fe_is_zero(r) ? ec_double(p, m) : pt_infinity(one);
  return o;
}

// A point in shared memory, word-major over `n` slots: word i of x at
// sm[i * n + slot], then y, then z (a warp's accesses hit distinct banks).
__device__ __forceinline__ void sm_store(uint32_t* sm, int n, int slot, const Pt& p) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    sm[i * n + slot] = p.x.w[i];
    sm[(NW + i) * n + slot] = p.y.w[i];
    sm[(2 * NW + i) * n + slot] = p.z.w[i];
  }
}

__device__ __forceinline__ Pt sm_load(const uint32_t* sm, int n, int slot) {
  Pt p;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    p.x.w[i] = sm[i * n + slot];
    p.y.w[i] = sm[(NW + i) * n + slot];
    p.z.w[i] = sm[(2 * NW + i) * n + slot];
  }
  return p;
}
