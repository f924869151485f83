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
// of them squares (fe_sqr gives the words of fe_montmul(a, a)).
__device__ __forceinline__ Pt ec_madd(const Pt& p, const Fe& x2, const Fe& y2, const Modulus& m) {
  Fe z1z1 = fe_sqr(p.z, m);
  Fe u2 = fe_montmul(x2, z1z1, m);
  Fe s2 = fe_montmul(y2, fe_montmul(p.z, z1z1, m), m);
  Fe h = fe_sub(u2, p.x, m);
  Fe r = fe_sub(s2, p.y, m);
  Fe hh = fe_sqr(h, m);
  Fe hhh = fe_montmul(h, hh, m);
  Fe v = fe_montmul(p.x, hh, m);
  Pt o;
  o.x = fe_sub(fe_sub(fe_sqr(r, m), hhh, m), fe_dbl(v, m), m);
  o.y = fe_sub(fe_montmul(r, fe_sub(v, o.x, m), m), fe_montmul(p.y, hhh, m), m);
  o.z = fe_montmul(p.z, h, m);
  return o;
}

// The general Jacobian sum without any select; H and R come back for the
// complete add. ops/ec.py `_add_core`. Not inlined, nor is ec_double: the
// combine kernel has seven adds and four doublings, and inlining their
// unrolled multiplies at every site made msm.cu take about a minute to build.
__device__ __noinline__ Pt ec_add_core(const Pt& p, const Pt& q, const Modulus& m, Fe& h,
                                       Fe& r) {
  Fe z1z1 = fe_montmul(p.z, p.z, m);
  Fe z2z2 = fe_montmul(q.z, q.z, m);
  Fe u1 = fe_montmul(p.x, z2z2, m);
  Fe u2 = fe_montmul(q.x, z1z1, m);
  Fe s1 = fe_montmul(p.y, fe_montmul(q.z, z2z2, m), m);
  Fe s2 = fe_montmul(q.y, fe_montmul(p.z, z1z1, m), m);
  h = fe_sub(u2, u1, m);
  r = fe_sub(s2, s1, m);
  Fe hh = fe_montmul(h, h, m);
  Fe hhh = fe_montmul(h, hh, m);
  Fe v = fe_montmul(u1, hh, m);
  Pt o;
  o.x = fe_sub(fe_sub(fe_montmul(r, r, m), hhh, m), fe_dbl(v, m), m);
  o.y = fe_sub(fe_montmul(r, fe_sub(v, o.x, m), m), fe_montmul(s1, hhh, m), m);
  o.z = fe_montmul(fe_montmul(p.z, q.z, m), h, m);
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
__device__ __noinline__ Pt ec_double(const Pt& p, const Modulus& m) {
  Fe a = fe_montmul(p.x, p.x, m);
  Fe b = fe_montmul(p.y, p.y, m);
  Fe c = fe_montmul(b, b, m);
  Fe xb = fe_add(p.x, b, m);
  Fe t = fe_montmul(xb, xb, m);
  Fe d = fe_dbl(fe_sub(fe_sub(t, a, m), c, m), m);
  Fe e = fe_add(fe_dbl(a, m), a, m);
  Fe f = fe_montmul(e, e, m);
  Fe c8 = fe_dbl(fe_dbl(fe_dbl(c, m), m), m);
  Pt o;
  o.x = fe_sub(f, fe_dbl(d, m), m);
  o.y = fe_sub(fe_montmul(e, fe_sub(d, o.x, m), m), c8, m);
  o.z = fe_montmul(fe_dbl(p.y, m), p.z, m);
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
