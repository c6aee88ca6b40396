// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the Hopper kernels.
// Elements are uint64_t; the torch side stores the same bits as int64.
// Every function takes and returns canonical values (< p).
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

// hi:lo mod p with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = hi_lo * EPS;
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;
  return canon(t2);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
