// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the Hopper kernels.
// Elements are uint64_t; the torch side stores the same bits as int64.
//
// Two families:
// - canonical: add, sub, mul take and return values < p;
// - lazy: add_lazy, add_canon_lazy, sub_lazy, mul_lazy, square_lazy,
//   mul_pow2 / mul_pow2_96 (times a compile-time power of two) and
//   reduce96 (which also takes a 96-bit sum, such as a * 2^s + b) take ANY
//   uint64_t and return some uint64_t congruent to the exact result mod p
//   (the ranges of boojum_tpu/field/goldilocks.py add_lazy .. canonicalize).
//   A chain of lazy operations ends in one canonicalize(), which maps any
//   uint64_t to [0, p). Since every step is exact mod p, the canonical end
//   result is bit-identical to the canonical-everywhere chain.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) {
  return x >= P ? x - P : x;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // 2^64 = EPS (mod p)
  return canon(s);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;
  return d;
}

// hi:lo mod p with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), for any 128-bit
// hi:lo; the result is < 2^64 but not always < p.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & EPS;
  // lo - hi_hi; a borrow leaves lo - hi_hi + 2^64 >= 2^64 - 2^32 + 1, which
  // stays >= 0 after subtracting EPS
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  // hi_lo * EPS < 2^64; after a carry t0 + t1 - 2^64 <= 2^64 - 2^33, so
  // adding EPS cannot carry again
  const uint64_t t1 = (hi_lo << 32) - hi_lo;
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;
  return t2;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return canon(reduce128(a * b, __umul64hi(a, b)));
}

// ---------------------------------------------------------------------------
// Lazy (any uint64_t) representatives. The carries go through 128-bit
// integers, so the compiler keeps them in the carry flags of its 32-bit adds
// instead of comparing 64-bit values; add_lazy and sub_lazy, the most
// frequent, take their carries straight from PTX's add.cc / sub.cc, which
// compiles to about a quarter fewer instructions than the 128-bit form.
// ---------------------------------------------------------------------------

using u128 = unsigned __int128;

__device__ __forceinline__ uint64_t canonicalize(uint64_t x) { return canon(x); }

// c * EPS for c in {0, 1}, and -EPS (mod 2^64) for c = 2^64 - 1.
__device__ __forceinline__ uint64_t times_eps(uint64_t c) { return (c << 32) - c; }

// Any v < 2^96 (hi < 2^32): lo + hi * EPS < 2^65 - 2^33, so after one carry
// the low word is at most 2^64 - 2^33 and adding EPS cannot carry again.
__device__ __forceinline__ uint64_t reduce96(u128 v) {
  const uint64_t hi = (uint64_t)(v >> 64);
  const u128 t = (u128)(uint64_t)v + times_eps(hi);
  return (uint64_t)t + times_eps((uint64_t)(t >> 64));
}

// Any 128-bit hi:lo with 2^64 = EPS and 2^96 = -1 (mod p):
// V = lo + hi_lo * 2^32 - hi_lo - hi_hi lies in (-2^32, 2^65), so its
// carry k out of 64 bits is -1, 0 or 1, and x + k * EPS (x its low 64 bits)
// stays inside [0, 2^64).
__device__ __forceinline__ uint64_t reduce128_lazy(u128 v) {
  const uint64_t lo = (uint64_t)v, hi = (uint64_t)(v >> 64);
  const uint64_t hi_hi = hi >> 32, hi_lo = hi & EPS;
  const u128 w = (u128)lo + (hi_lo << 32) - (hi_lo + hi_hi);
  return (uint64_t)w + times_eps((uint64_t)(w >> 64));
}

// a + b: on a carry add EPS (2^64 = EPS mod p), and once more if that
// carries. Each asm block pairs add.cc with addc (or sub.cc with subc), so
// the carry flag never crosses a block.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint64_t s, t;
  uint32_t c, c2;
  asm("add.cc.u64 %0, %2, %3;\n\taddc.u32 %1, 0, 0;"
      : "=l"(s), "=r"(c) : "l"(a), "l"(b));
  asm("add.cc.u64 %0, %2, %3;\n\taddc.u32 %1, 0, 0;"
      : "=l"(t), "=r"(c2) : "l"(s), "l"((uint64_t)(0u - c)));
  return t + (0u - c2);
}

// a + c for a canonical constant c < p: after a carry the low word is below
// p - 1, so one EPS fix cannot carry.
__device__ __forceinline__ uint64_t add_canon_lazy(uint64_t a, uint64_t c) {
  const u128 s = (u128)a + c;
  return (uint64_t)s + times_eps((uint64_t)(s >> 64));
}

// a - b: on a borrow subtract EPS, and once more if that borrows (subc of
// 0 - 0 leaves 0xFFFFFFFF = EPS exactly on a borrow).
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  uint64_t d, e;
  uint32_t m, m2;
  asm("sub.cc.u64 %0, %2, %3;\n\tsubc.u32 %1, 0, 0;"
      : "=l"(d), "=r"(m) : "l"(a), "l"(b));
  asm("sub.cc.u64 %0, %2, %3;\n\tsubc.u32 %1, 0, 0;"
      : "=l"(e), "=r"(m2) : "l"(d), "l"((uint64_t)m));
  return e - m2;
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy((u128)a * b);
}

// a^2 from three 32x32->64 partial products: the cross term a0*a1 counts
// twice, so it is shifted by 33 instead of added twice.
__device__ __forceinline__ uint64_t square_lazy(uint64_t a) {
  const uint64_t a0 = (uint32_t)a, a1 = a >> 32;
  const u128 sq = ((u128)(a1 * a1) << 64) + a0 * a0 + ((u128)(a0 * a1) << 33);
  return reduce128_lazy(sq);
}

// x * 2^e for any uint64_t x and a compile-time 0 <= e < 96 (after
// inlining every branch folds away):
//   e <= 32: x * 2^e < 2^96, one reduce96;
//   e < 64:  x * 2^e < 2^128, one reduce128_lazy;
//   e < 96:  with x = xh * 2^32 + xl, xl * 2^e < 2^128 and
//            xh * 2^(e + 32) = -xh * 2^(e - 64) (2^96 = -1), where
//            xh * 2^(e - 64) < 2^64: one reduce128_lazy and one sub_lazy.
__device__ __forceinline__ uint64_t mul_pow2_96(uint64_t x, int e) {
  if (e == 0) return x;
  if (e <= 32) return reduce96((u128)x << e);
  if (e < 64) return reduce128_lazy((u128)x << e);
  const uint64_t xl = (uint32_t)x, xh = x >> 32;
  return sub_lazy(reduce128_lazy((u128)xl << e), xh << (e - 64));
}

// x * 2^e mod p, lazy, for a compile-time 0 <= e < 192 (2^192 = 1): the
// factors 2^e with e >= 96 are -2^(e - 96). The butterflies fold that sign
// into their add and subtract instead of negating.
__device__ __forceinline__ uint64_t mul_pow2(uint64_t x, int e) {
  return e < 96 ? mul_pow2_96(x, e) : sub_lazy(0, mul_pow2_96(x, e - 96));
}

}  // namespace gl
