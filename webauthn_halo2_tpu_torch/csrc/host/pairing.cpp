// Native bn254 pairing + G1 MSM for the host verifier cold path.
//
// The reference verifies an ECDSA proof in ~3.7 ms on CPU
// (halo2-circuits/src/results/ecdsa_bench.csv:4, backed by
// halo2curves::bn256); the pure-Python verifier in this repo spends
// ~200 ms in one pairing check alone. This library brings the host
// verifier into the same class: 4x64 Montgomery Fq, the standard
// Fq2/Fq6/Fq12 tower (Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - (9+u)),
// Fq12 = Fq6[w]/(w^2 - v)), affine optimal-ate Miller loop on the
// D-twist, Frobenius-chain final exponentiation, and a Straus
// window-4 Jacobian MSM over G1.
//
// Exposed via ctypes (fields/pairing_native.py), built at first use by
// utils/host_build.py into build/host/; the pure-Python implementation in
// fields/pairing.py (pairing_check_py) stays as the correctness oracle
// (tests/test_torch_native.py), never as a fallback.

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

typedef unsigned __int128 u128;

// ---------------------------------------------------------------- Fq ---

struct Fq {
  uint64_t l[4];
};

constexpr Fq P = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                   0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
constexpr uint64_t PINV = 0x87d20782e4866389ULL;  // -p^-1 mod 2^64
constexpr Fq R2 = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                    0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};
constexpr Fq ONE = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                     0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};
constexpr Fq ZERO = {{0, 0, 0, 0}};

inline bool is_zero(const Fq &a) {
  return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}

inline bool eq(const Fq &a, const Fq &b) {
  return a.l[0] == b.l[0] && a.l[1] == b.l[1] && a.l[2] == b.l[2] &&
         a.l[3] == b.l[3];
}

inline bool geq_p(const Fq &a) {
  for (int i = 3; i >= 0; --i) {
    if (a.l[i] > P.l[i]) return true;
    if (a.l[i] < P.l[i]) return false;
  }
  return true;  // equal
}

inline Fq add(const Fq &a, const Fq &b) {
  Fq r;
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.l[i] + b.l[i];
    r.l[i] = (uint64_t)c;
    c >>= 64;
  }
  if (c || geq_p(r)) {
    u128 br = 0;
    for (int i = 0; i < 4; ++i) {
      u128 d = (u128)r.l[i] - P.l[i] - br;
      r.l[i] = (uint64_t)d;
      br = (d >> 64) & 1;
    }
  }
  return r;
}

inline Fq sub(const Fq &a, const Fq &b) {
  Fq r;
  u128 br = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.l[i] - b.l[i] - br;
    r.l[i] = (uint64_t)d;
    br = (d >> 64) & 1;
  }
  if (br) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      c += (u128)r.l[i] + P.l[i];
      r.l[i] = (uint64_t)c;
      c >>= 64;
    }
  }
  return r;
}

inline Fq neg(const Fq &a) { return is_zero(a) ? a : sub(ZERO, a); }

inline Fq dbl(const Fq &a) { return add(a, a); }

// CIOS Montgomery multiplication.
inline Fq mul(const Fq &a, const Fq &b) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      c = (u128)a.l[i] * b.l[j] + t[j] + (uint64_t)c;
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    u128 s = (u128)t[4] + (uint64_t)c;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);
    uint64_t m = t[0] * PINV;
    c = (u128)m * P.l[0] + t[0];
    c >>= 64;
    for (int j = 1; j < 4; ++j) {
      c = (u128)m * P.l[j] + t[j] + (uint64_t)c;
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    s = (u128)t[4] + (uint64_t)c;
    t[3] = (uint64_t)s;
    t[4] = t[5] + (uint64_t)(s >> 64);
  }
  Fq r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || geq_p(r)) {
    u128 br = 0;
    for (int i = 0; i < 4; ++i) {
      u128 d = (u128)r.l[i] - P.l[i] - br;
      r.l[i] = (uint64_t)d;
      br = (d >> 64) & 1;
    }
  }
  return r;
}

inline Fq sqr(const Fq &a) { return mul(a, a); }

Fq fq_pow(const Fq &a, const uint64_t *e, int nlimbs) {
  Fq r = ONE, base = a;
  for (int i = 0; i < nlimbs; ++i) {
    uint64_t w = e[i];
    for (int b = 0; b < 64; ++b) {
      if (w & 1) r = mul(r, base);
      base = sqr(base);
      w >>= 1;
    }
  }
  return r;
}

Fq inv(const Fq &a) {
  // Fermat: a^(p-2).
  uint64_t e[4] = {P.l[0] - 2, P.l[1], P.l[2], P.l[3]};
  return fq_pow(a, e, 4);
}

inline Fq to_mont(const Fq &a) { return mul(a, R2); }

inline Fq from_mont(const Fq &a) {
  Fq one_raw = {{1, 0, 0, 0}};
  return mul(a, one_raw);
}

// --------------------------------------------------------------- Fq2 ---

struct Fq2 {
  Fq a, b;  // a + b*u, u^2 = -1
};

const Fq2 F2_ZERO = {ZERO, ZERO};
const Fq2 F2_ONE = {ONE, ZERO};

inline bool is_zero(const Fq2 &x) { return is_zero(x.a) && is_zero(x.b); }
inline bool eq(const Fq2 &x, const Fq2 &y) {
  return eq(x.a, y.a) && eq(x.b, y.b);
}
inline Fq2 add(const Fq2 &x, const Fq2 &y) {
  return {add(x.a, y.a), add(x.b, y.b)};
}
inline Fq2 sub(const Fq2 &x, const Fq2 &y) {
  return {sub(x.a, y.a), sub(x.b, y.b)};
}
inline Fq2 neg(const Fq2 &x) { return {neg(x.a), neg(x.b)}; }
inline Fq2 conj(const Fq2 &x) { return {x.a, neg(x.b)}; }

inline Fq2 mul(const Fq2 &x, const Fq2 &y) {
  // Karatsuba: 3 Fq muls.
  Fq t0 = mul(x.a, y.a);
  Fq t1 = mul(x.b, y.b);
  Fq t2 = mul(add(x.a, x.b), add(y.a, y.b));
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

inline Fq2 sqr(const Fq2 &x) {
  // (a+bu)^2 = (a+b)(a-b) + 2ab u
  Fq t0 = mul(add(x.a, x.b), sub(x.a, x.b));
  Fq t1 = mul(x.a, x.b);
  return {t0, dbl(t1)};
}

inline Fq2 mul_fq(const Fq2 &x, const Fq &s) {
  return {mul(x.a, s), mul(x.b, s)};
}

// multiply by xi = 9 + u
inline Fq2 mul_xi(const Fq2 &x) {
  Fq nine_a = add(dbl(dbl(dbl(x.a))), x.a);
  Fq nine_b = add(dbl(dbl(dbl(x.b))), x.b);
  return {sub(nine_a, x.b), add(nine_b, x.a)};
}

Fq2 inv(const Fq2 &x) {
  // 1/(a+bu) = (a - bu)/(a^2 + b^2)
  Fq t = inv(add(sqr(x.a), sqr(x.b)));
  return {mul(x.a, t), neg(mul(x.b, t))};
}

// --------------------------------------------------------------- Fq6 ---

struct Fq6 {
  Fq2 a, b, c;  // a + b v + c v^2, v^3 = xi
};

const Fq6 F6_ZERO = {F2_ZERO, F2_ZERO, F2_ZERO};
const Fq6 F6_ONE = {F2_ONE, F2_ZERO, F2_ZERO};

inline bool is_zero(const Fq6 &x) {
  return is_zero(x.a) && is_zero(x.b) && is_zero(x.c);
}
inline Fq6 add(const Fq6 &x, const Fq6 &y) {
  return {add(x.a, y.a), add(x.b, y.b), add(x.c, y.c)};
}
inline Fq6 sub(const Fq6 &x, const Fq6 &y) {
  return {sub(x.a, y.a), sub(x.b, y.b), sub(x.c, y.c)};
}
inline Fq6 neg(const Fq6 &x) { return {neg(x.a), neg(x.b), neg(x.c)}; }

inline Fq6 mul(const Fq6 &x, const Fq6 &y) {
  // Toom/Karatsuba-lite (schoolbook with shared products).
  Fq2 aa = mul(x.a, y.a), bb = mul(x.b, y.b), cc = mul(x.c, y.c);
  Fq2 t1 = mul(add(x.b, x.c), add(y.b, y.c));  // bc cross
  t1 = sub(sub(t1, bb), cc);                   // x.b*y.c + x.c*y.b
  Fq2 t2 = mul(add(x.a, x.b), add(y.a, y.b));
  t2 = sub(sub(t2, aa), bb);                   // a*y.b + b*y.a
  Fq2 t3 = mul(add(x.a, x.c), add(y.a, y.c));
  t3 = sub(add(sub(t3, aa), bb), cc);          // a*y.c + c*y.a + bb
  return {add(aa, mul_xi(t1)), add(t2, mul_xi(cc)), t3};
}

inline Fq6 sqr(const Fq6 &x) { return mul(x, x); }

inline Fq6 mul_v(const Fq6 &x) {
  // (a + b v + c v^2) * v = xi c + a v + b v^2
  return {mul_xi(x.c), x.a, x.b};
}

inline Fq6 mul_fq2(const Fq6 &x, const Fq2 &s) {
  return {mul(x.a, s), mul(x.b, s), mul(x.c, s)};
}

Fq6 inv(const Fq6 &x) {
  // Standard: c0 = a^2 - xi b c, c1 = xi c^2 - a b, c2 = b^2 - a c
  // t = a c0 + xi (c c1 + b c2); inv = (c0 + c1 v + c2 v^2)/t
  Fq2 c0 = sub(sqr(x.a), mul_xi(mul(x.b, x.c)));
  Fq2 c1 = sub(mul_xi(sqr(x.c)), mul(x.a, x.b));
  Fq2 c2 = sub(sqr(x.b), mul(x.a, x.c));
  Fq2 t = add(mul(x.a, c0), mul_xi(add(mul(x.c, c1), mul(x.b, c2))));
  Fq2 ti = inv(t);
  return {mul(c0, ti), mul(c1, ti), mul(c2, ti)};
}

// -------------------------------------------------------------- Fq12 ---

struct Fq12 {
  Fq6 a, b;  // a + b w, w^2 = v
};

const Fq12 F12_ONE = {F6_ONE, F6_ZERO};

inline Fq12 mul(const Fq12 &x, const Fq12 &y) {
  Fq6 aa = mul(x.a, y.a);
  Fq6 bb = mul(x.b, y.b);
  Fq6 t = mul(add(x.a, x.b), add(y.a, y.b));
  return {add(aa, mul_v(bb)), sub(sub(t, aa), bb)};
}

inline Fq12 sqr_generic(const Fq12 &x) {
  // (a + bw)^2 = (a^2 + v b^2) + 2ab w, via Karatsuba-style:
  Fq6 ab = mul(x.a, x.b);
  Fq6 t = mul(add(x.a, x.b), add(x.a, mul_v(x.b)));
  Fq6 re = sub(sub(t, ab), mul_v(ab));
  Fq6 im = add(ab, ab);
  return {re, im};
}

inline Fq12 conj(const Fq12 &x) { return {x.a, neg(x.b)}; }

Fq12 inv(const Fq12 &x) {
  // 1/(a+bw) = (a - bw)/(a^2 - v b^2)
  Fq6 t = inv(sub(sqr(x.a), mul_v(sqr(x.b))));
  return {mul(x.a, t), neg(mul(x.b, t))};
}

inline bool is_one(const Fq12 &x) {
  return eq(x.a.a, F2_ONE) && is_zero(x.a.b) && is_zero(x.a.c) &&
         is_zero(x.b);
}

// Frobenius coefficients: FROB1[k] = xi^(k(q-1)/6) in Fq2 (Montgomery
// form, converted at init); FROB2[k] = xi^(k(q^2-1)/6) in Fq;
// FROB3[k] = xi^(k(q^3-1)/6) in Fq2. k = 1..5 stored at index k-1.
const uint64_t FROB1_RAW[5][8] = {
    {0xd60b35dadcc9e470ULL, 0x5c521e08292f2176ULL, 0xe8b99fdd76e68b60ULL,
     0x1284b71c2865a7dfULL, 0xca5cf05f80f362acULL, 0x747992778eeec7e5ULL,
     0xa6327cfe12150b8eULL, 0x246996f3b4fae7e6ULL},
    {0x99e39557176f553dULL, 0xb78cc310c2c3330cULL, 0x4c0bec3cf559b143ULL,
     0x2fb347984f7911f7ULL, 0x1665d51c640fcba2ULL, 0x32ae2a1d0b7c9dceULL,
     0x4ba4cc8bd75a0794ULL, 0x16c9e55061ebae20ULL},
    {0xdc54014671a0135aULL, 0xdbaae0eda9c95998ULL, 0xdc5ec698b6e2f9b9ULL,
     0x063cf305489af5dcULL, 0x82d37f632623b0e3ULL, 0x21807dc98fa25bd2ULL,
     0x0704b5a7ec796f2bULL, 0x07c03cbcac41049aULL},
    {0x848a1f55921ea762ULL, 0xd33365f7be94ec72ULL, 0x80f3c0b75a181e84ULL,
     0x05b54f5e64eea801ULL, 0xc13b4711cd2b8126ULL, 0x3685d2ea1bdec763ULL,
     0x9f3a80b03b0b1c92ULL, 0x2c145edbe7fd8aeeULL},
    {0x2ea2c810eab7692fULL, 0x425c459b55aa1bd3ULL, 0xe93a3661a4353ff4ULL,
     0x0183c1e74f798649ULL, 0x24c6b8ee6e0c2c4bULL, 0xb080cb99678e2ac0ULL,
     0xa27fb246c7729f7dULL, 0x12acf2ca76fd0675ULL}};
const uint64_t FROB2_RAW[5][4] = {
    {0xe4bd44e5607cfd49ULL, 0xc28f069fbb966e3dULL, 0x5e6dd9e7e0acccb0ULL,
     0x30644e72e131a029ULL},
    {0xe4bd44e5607cfd48ULL, 0xc28f069fbb966e3dULL, 0x5e6dd9e7e0acccb0ULL,
     0x30644e72e131a029ULL},
    {0x3c208c16d87cfd46ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL,
     0x30644e72e131a029ULL},
    {0x5763473177fffffeULL, 0xd4f263f1acdb5c4fULL, 0x59e26bcea0d48bacULL,
     0x0000000000000000ULL},
    {0x5763473177ffffffULL, 0xd4f263f1acdb5c4fULL, 0x59e26bcea0d48bacULL,
     0x0000000000000000ULL}};
const uint64_t FROB3_RAW[5][8] = {
    {0xe86f7d391ed4a67fULL, 0x894cb38dbe55d24aULL, 0xefe9608cd0acaa90ULL,
     0x19dc81cfcc82e4bbULL, 0x7694aa2bf4c0c101ULL, 0x7f03a5e397d439ecULL,
     0x06cbeee33576139dULL, 0x00abf8b60be77d73ULL},
    {0x7b746ee87bdcfb6dULL, 0x805ffd3d5d6942d3ULL, 0xbaff1c77959f25acULL,
     0x0856e078b755ef0aULL, 0x380cab2baaa586deULL, 0x0fdf31bf98ff2631ULL,
     0xa9f30e6dec26094fULL, 0x04f1de41b3d1766fULL},
    {0x5fcc8ad066dce9edULL, 0xbbd689a3bea870f4ULL, 0xdbf17f1dca9e5ea3ULL,
     0x2a275b6d9896aa4cULL, 0xb94d0cb3b2594c64ULL, 0x7600ecc7d8cf6ebaULL,
     0xb14b900e9507e932ULL, 0x28a411b634f09b8fULL},
    {0x0e1a92bc3ccbf066ULL, 0xe633094575b06bcbULL, 0x19bee0f7b5b2444eULL,
     0x0bc58c6611c08dabULL, 0x5fe3ed9d730c239fULL, 0xa44a9e08737f96e5ULL,
     0xfeb0f6ef0cd21d04ULL, 0x23d5e999e1910a12ULL},
    {0xebde847076261b43ULL, 0x2ed68098967c84a5ULL, 0x711699fa3b4d3f69ULL,
     0x13c49044952c0905ULL, 0x1f25041384282499ULL, 0x3e2ddaea20028021ULL,
     0x9fb1b2282a48633dULL, 0x16db366a59b1dd0bULL}};

Fq2 FROB1[5], FROB3[5];
Fq FROB2[5];
std::once_flag frob_once;

// Fills the Frobenius tables once per process. The library is called from
// several threads at once (ctypes releases the GIL), so the first callers
// wait here until the tables are written.
void frob_fill() {
  for (int k = 0; k < 5; ++k) {
    Fq a = {{FROB1_RAW[k][0], FROB1_RAW[k][1], FROB1_RAW[k][2],
             FROB1_RAW[k][3]}};
    Fq b = {{FROB1_RAW[k][4], FROB1_RAW[k][5], FROB1_RAW[k][6],
             FROB1_RAW[k][7]}};
    FROB1[k] = {to_mont(a), to_mont(b)};
    Fq c = {{FROB2_RAW[k][0], FROB2_RAW[k][1], FROB2_RAW[k][2],
             FROB2_RAW[k][3]}};
    FROB2[k] = to_mont(c);
    Fq d = {{FROB3_RAW[k][0], FROB3_RAW[k][1], FROB3_RAW[k][2],
             FROB3_RAW[k][3]}};
    Fq e = {{FROB3_RAW[k][4], FROB3_RAW[k][5], FROB3_RAW[k][6],
             FROB3_RAW[k][7]}};
    FROB3[k] = {to_mont(d), to_mont(e)};
  }
}

void frob_init() { std::call_once(frob_once, frob_fill); }

Fq12 frob1(const Fq12 &x) {
  return {{conj(x.a.a), mul(conj(x.a.b), FROB1[1]), mul(conj(x.a.c), FROB1[3])},
          {mul(conj(x.b.a), FROB1[0]), mul(conj(x.b.b), FROB1[2]),
           mul(conj(x.b.c), FROB1[4])}};
}

Fq12 frob2(const Fq12 &x) {
  return {{x.a.a, mul_fq(x.a.b, FROB2[1]), mul_fq(x.a.c, FROB2[3])},
          {mul_fq(x.b.a, FROB2[0]), mul_fq(x.b.b, FROB2[2]),
           mul_fq(x.b.c, FROB2[4])}};
}

Fq12 frob3(const Fq12 &x) {
  return {{conj(x.a.a), mul(conj(x.a.b), FROB3[1]), mul(conj(x.a.c), FROB3[3])},
          {mul(conj(x.b.a), FROB3[0]), mul(conj(x.b.b), FROB3[2]),
           mul(conj(x.b.c), FROB3[4])}};
}

// ----------------------------------------------------------- pairing ---

// BN parameter x and the ate loop count 6x+2.
constexpr uint64_t BN_X = 4965661367192848881ULL;
constexpr uint64_t ATE_LOOP = 0x9d797039be763ba8ULL;  // low 64 bits
constexpr int ATE_TOP_BIT = 64;  // bit 64 is set (value = 2^64 + ATE_LOOP)

struct G2Aff {
  Fq2 x, y;
  bool inf;
};

struct G1Aff {
  Fq x, y;
  bool inf;
};

// Line through (affine twist) points t1, t2 evaluated at P, as a sparse
// Fq12: yP + (-lam*xP) w + (lam*x1 - y1) v w, where lam is the twist
// slope. Returns the full Fq12 (sparseness not exploited yet).
Fq12 line_eval(const G2Aff &t1, const G2Aff &t2, const G1Aff &p) {
  Fq2 lam;
  if (!eq(t1.x, t2.x)) {
    lam = mul(sub(t2.y, t1.y), inv(sub(t2.x, t1.x)));
  } else if (eq(t1.y, t2.y)) {
    Fq2 x2 = sqr(t1.x);
    Fq2 num = add(add(x2, x2), x2);
    lam = mul(num, inv(add(t1.y, t1.y)));
  } else {
    // vertical line: xP - x1 w^2 = xP - x1 v
    Fq12 v;
    Fq2 xp = {p.x, ZERO};
    v.a = {xp, neg(t1.x), F2_ZERO};
    v.b = F6_ZERO;
    return v;
  }
  Fq12 r;
  Fq2 yp = {p.y, ZERO};
  r.a = {yp, F2_ZERO, F2_ZERO};
  r.b = {neg(mul_fq(lam, p.x)), sub(mul(lam, t1.x), t1.y), F2_ZERO};
  return r;
}

G2Aff g2_add(const G2Aff &a, const G2Aff &b) {
  if (a.inf) return b;
  if (b.inf) return a;
  Fq2 lam;
  if (eq(a.x, b.x)) {
    if (!eq(a.y, b.y)) return {F2_ZERO, F2_ZERO, true};
    Fq2 x2 = sqr(a.x);
    lam = mul(add(add(x2, x2), x2), inv(add(a.y, a.y)));
  } else {
    lam = mul(sub(b.y, a.y), inv(sub(b.x, a.x)));
  }
  Fq2 x3 = sub(sub(sqr(lam), a.x), b.x);
  Fq2 y3 = sub(mul(lam, sub(a.x, x3)), a.y);
  return {x3, y3, false};
}

// One Miller loop f_{6x+2,Q}(P) + the two Frobenius lines, multiplied
// into f (caller accumulates across pairs; one shared final exp).
void miller_accumulate(Fq12 &f, const G2Aff &q, const G1Aff &p) {
  G2Aff r = q;
  Fq12 acc = F12_ONE;
  for (int i = ATE_TOP_BIT - 1; i >= 0; --i) {
    acc = sqr_generic(acc);
    acc = mul(acc, line_eval(r, r, p));
    r = g2_add(r, r);
    bool bit = (i < 64) ? ((ATE_LOOP >> i) & 1) : 0;
    if (bit) {
      acc = mul(acc, line_eval(r, q, p));
      r = g2_add(r, q);
    }
  }
  // Q1 = pi(Q): (conj(x) g12, conj(y) g13); g12 = FROB1[1] (= xi^((q-1)/3)),
  // g13 = FROB1[2] (= xi^((q-1)/2)).
  G2Aff q1 = {mul(conj(q.x), FROB1[1]), mul(conj(q.y), FROB1[2]), false};
  // -pi^2(Q) = (x * xi^((q^2-1)/3), y)   [xi^((q^2-1)/2) = -1]
  G2Aff nq2 = {mul_fq(q.x, FROB2[1]), q.y, false};
  acc = mul(acc, line_eval(r, q1, p));
  r = g2_add(r, q1);
  acc = mul(acc, line_eval(r, nq2, p));
  f = mul(f, acc);
}

Fq12 pow_x(const Fq12 &a) {
  Fq12 r = F12_ONE, base = a;
  uint64_t e = BN_X;
  while (e) {
    if (e & 1) r = mul(r, base);
    base = sqr_generic(base);
    e >>= 1;
  }
  return r;
}

Fq12 final_exp(const Fq12 &f) {
  // easy part: f^((q^6-1)(q^2+1))
  Fq12 t = mul(conj(f), inv(f));
  t = mul(frob2(t), t);
  // hard part (Devegili et al. chain, as in libff alt_bn128):
  Fq12 fu = pow_x(t);
  Fq12 fu2 = pow_x(fu);
  Fq12 fu3 = pow_x(fu2);
  Fq12 y0 = mul(mul(frob1(t), frob2(t)), frob3(t));
  Fq12 y1 = conj(t);
  Fq12 y2 = frob2(fu2);
  Fq12 y3 = conj(frob1(fu));
  Fq12 y4 = conj(mul(fu, frob1(fu2)));
  Fq12 y5 = conj(fu2);
  Fq12 y6 = conj(mul(fu3, frob1(fu3)));
  Fq12 t0 = mul(mul(sqr_generic(y6), y4), y5);
  Fq12 t1 = mul(mul(y3, y5), t0);
  t0 = mul(t0, y2);
  t1 = mul(sqr_generic(t1), t0);
  t1 = sqr_generic(t1);
  t0 = mul(t1, y1);
  t1 = mul(t1, y0);
  t0 = sqr_generic(t0);
  return mul(t1, t0);
}

// ---------------------------------------------------------- G1 (Fq) ---

struct G1Jac {
  Fq x, y, z;  // z == 0 -> infinity
};

G1Jac jdbl(const G1Jac &p) {
  if (is_zero(p.z) || is_zero(p.y)) return {ONE, ONE, ZERO};
  Fq a = sqr(p.x);
  Fq b = sqr(p.y);
  Fq c = sqr(b);
  Fq d = sub(sqr(add(p.x, b)), add(a, c));
  d = dbl(d);
  Fq e = add(dbl(a), a);
  Fq ff = sqr(e);
  Fq x3 = sub(ff, dbl(d));
  Fq c8 = dbl(dbl(dbl(c)));
  Fq y3 = sub(mul(e, sub(d, x3)), c8);
  Fq z3 = mul(dbl(p.y), p.z);
  return {x3, y3, z3};
}

G1Jac jadd(const G1Jac &p, const G1Jac &q) {
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  Fq z1z1 = sqr(p.z);
  Fq z2z2 = sqr(q.z);
  Fq u1 = mul(p.x, z2z2);
  Fq u2 = mul(q.x, z1z1);
  Fq s1 = mul(mul(p.y, q.z), z2z2);
  Fq s2 = mul(mul(q.y, p.z), z1z1);
  if (eq(u1, u2)) {
    if (!eq(s1, s2)) return {ONE, ONE, ZERO};
    return jdbl(p);
  }
  Fq h = sub(u2, u1);
  Fq i = sqr(dbl(h));
  Fq j = mul(h, i);
  Fq rr = dbl(sub(s2, s1));
  Fq v = mul(u1, i);
  Fq x3 = sub(sub(sqr(rr), j), dbl(v));
  Fq y3 = sub(mul(rr, sub(v, x3)), dbl(mul(s1, j)));
  Fq z3 = mul(mul(dbl(p.z), q.z), h);
  return {x3, y3, z3};
}

}  // namespace

// ------------------------------------------------------------- C API ---

extern "C" {

// scalars: n*4 LE u64 limbs (plain ints < r). points: n*8 LE u64 limbs
// (x,y plain ints; x=y=0 means infinity). out: 8 u64 (affine x,y; all
// zero for infinity). Returns 0.
int wh2_g1_msm(const uint64_t *scalars, const uint64_t *points, uint64_t n,
               uint64_t *out) {
  frob_init();
  G1Jac acc = {ONE, ONE, ZERO};
  // Straus window-4: per-point table of 15 multiples.
  const int W = 4;
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t *sp = scalars + 4 * i;
    const uint64_t *pp = points + 8 * i;
    bool inf = true;
    for (int j = 0; j < 8; ++j) inf = inf && pp[j] == 0;
    bool zero_sc = (sp[0] | sp[1] | sp[2] | sp[3]) == 0;
    if (inf || zero_sc) continue;
    Fq px = to_mont({{pp[0], pp[1], pp[2], pp[3]}});
    Fq py = to_mont({{pp[4], pp[5], pp[6], pp[7]}});
    G1Jac base = {px, py, ONE};
    // double-and-add, 4-bit windows from the top
    G1Jac tbl[16];
    tbl[0] = {ONE, ONE, ZERO};
    tbl[1] = base;
    for (int j = 2; j < 16; ++j) tbl[j] = jadd(tbl[j - 1], base);
    G1Jac r = {ONE, ONE, ZERO};
    for (int d = 63; d >= 0; --d) {
      for (int b = 0; b < W; ++b) r = jdbl(r);
      int limb = d / 16;
      int off = (d % 16) * 4;
      int digit = (int)((sp[limb] >> off) & 0xF);
      if (digit) r = jadd(r, tbl[digit]);
    }
    acc = jadd(acc, r);
  }
  if (is_zero(acc.z)) {
    memset(out, 0, 8 * sizeof(uint64_t));
    return 0;
  }
  Fq zi = inv(acc.z);
  Fq zi2 = sqr(zi);
  Fq ax = from_mont(mul(acc.x, zi2));
  Fq ay = from_mont(mul(acc.y, mul(zi2, zi)));
  memcpy(out, ax.l, 4 * sizeof(uint64_t));
  memcpy(out + 4, ay.l, 4 * sizeof(uint64_t));
  return 0;
}

// g1: n*8 limbs (x,y plain; x=y=0 -> skip pair). g2: n*16 limbs
// (x0,x1,y0,y1 each 4 limbs, plain). Returns 1 if the product of
// pairings is one, 0 if not, -1 on malformed input.
int wh2_pairing_check(const uint64_t *g1, const uint64_t *g2, uint64_t n) {
  frob_init();
  Fq12 f = F12_ONE;
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t *pp = g1 + 8 * i;
    const uint64_t *qq = g2 + 16 * i;
    bool inf = true;
    for (int j = 0; j < 8; ++j) inf = inf && pp[j] == 0;
    if (inf) continue;
    G1Aff p = {to_mont({{pp[0], pp[1], pp[2], pp[3]}}),
               to_mont({{pp[4], pp[5], pp[6], pp[7]}}), false};
    G2Aff q = {{to_mont({{qq[0], qq[1], qq[2], qq[3]}}),
                to_mont({{qq[4], qq[5], qq[6], qq[7]}})},
               {to_mont({{qq[8], qq[9], qq[10], qq[11]}}),
                to_mont({{qq[12], qq[13], qq[14], qq[15]}})},
               false};
    miller_accumulate(f, q, p);
  }
  return is_one(final_exp(f)) ? 1 : 0;
}

}  // extern "C"
