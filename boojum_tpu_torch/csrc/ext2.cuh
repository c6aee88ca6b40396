// GoldilocksExt2 (u^2 = 7) on goldilocks.cuh's lazy representatives, for
// the kernels that work in the extension (stage23.cu, quotient.cu): any
// uint64_t in, some uint64_t congruent out; a caller canonicalizes what it
// compares with 0 or stores.
#pragma once
#include <cstdint>

#include "goldilocks.cuh"

namespace gl {

struct E2 {
  uint64_t c0, c1;
};

// 7x for any x: a 67-bit product, one 96-bit reduction
__device__ __forceinline__ uint64_t mul7(uint64_t x) {
  return reduce96((u128)x * 7);
}

__device__ __forceinline__ E2 e2_add(E2 a, E2 b) {
  return E2{add_lazy(a.c0, b.c0), add_lazy(a.c1, b.c1)};
}

__device__ __forceinline__ E2 e2_sub(E2 a, E2 b) {
  return E2{sub_lazy(a.c0, b.c0), sub_lazy(a.c1, b.c1)};
}

// (a0 + a1 u)(b0 + b1 u) with u^2 = 7, by Karatsuba
__device__ __forceinline__ E2 e2_mul(E2 a, E2 b) {
  const uint64_t v0 = mul_lazy(a.c0, b.c0), v1 = mul_lazy(a.c1, b.c1);
  const uint64_t s = mul_lazy(add_lazy(a.c0, a.c1), add_lazy(b.c0, b.c1));
  return E2{add_lazy(v0, mul7(v1)), sub_lazy(sub_lazy(s, v0), v1)};
}

__device__ __forceinline__ E2 e2_scale(E2 a, uint64_t x) {
  return E2{mul_lazy(a.c0, x), mul_lazy(a.c1, x)};
}

// x * y + u + v, one reduction: x * y <= (2^64 - 1)^2 = 2^128 - 2^65 + 1, so
// the 128-bit sum does not wrap for any uint64_t x, y, u, v
__device__ __forceinline__ uint64_t mul_add2(uint64_t x, uint64_t y,
                                             uint64_t u, uint64_t v) {
  return reduce128_lazy((u128)x * y + u + v);
}

// w + b*s + g for the ext scalars b, g
__device__ __forceinline__ E2 affine(uint64_t w, uint64_t s, E2 b, E2 g) {
  return E2{mul_add2(s, b.c0, w, g.c0), mul_add2(s, b.c1, g.c1, 0)};
}

}  // namespace gl
