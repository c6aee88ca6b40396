// poseidon2_permute: the Poseidon2 permutation (Goldilocks, width 12) of B
// independent states.
//
// Replaces the TPU kernel boojum_tpu/hash/pallas_poseidon2.py:_kernel.
// Rounds: external MDS; 4 full rounds (round constants, x^7 s-box on every
// element, external MDS = M4 addition chains inside the block circulant
// [[2,1,1],[1,2,1],[1,1,2]]); 22 partial rounds (constant and s-box on
// element 0, then el[i]·2^shift[i] + sum(el)); 4 more full rounds. Outputs
// are canonical, so they are bit-identical to the TPU kernel's.
//
// Design: one thread per state, the 12 elements in registers, the round
// constants and shifts in __constant__ memory. The state is element-major,
// (12, B), so neighbouring threads read and write neighbouring addresses.
// Each state is read and written once (192 bytes) against 472 s-box field
// multiplies (8 full rounds x 12 x 4, 22 partial rounds x 4), each at least 4
// 32-bit integer multiply-adds: the kernel is bound by operations, not bytes.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int THREADS = 128;

__constant__ uint64_t c_rc[ROUNDS * WIDTH];
__constant__ uint64_t c_diag[WIDTH];  // 2^shift[i]

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x3 = gl::mul(x, x2);
  const uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(x3, x4);
}

__device__ __forceinline__ void external_mds(uint64_t* el) {
  uint64_t b[3][4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint64_t x0 = el[4 * k], x1 = el[4 * k + 1];
    const uint64_t x2 = el[4 * k + 2], x3 = el[4 * k + 3];
    const uint64_t t0 = gl::add(x0, x1);
    const uint64_t t1 = gl::add(x2, x3);
    const uint64_t t2 = gl::add(gl::add(x1, x1), t1);
    const uint64_t t3 = gl::add(gl::add(x3, x3), t0);
    const uint64_t t1x4 = gl::add(gl::add(t1, t1), gl::add(t1, t1));
    const uint64_t t0x4 = gl::add(gl::add(t0, t0), gl::add(t0, t0));
    const uint64_t t4 = gl::add(t1x4, t3);
    const uint64_t t5 = gl::add(t0x4, t2);
    b[k][0] = gl::add(t3, t5);
    b[k][1] = t5;
    b[k][2] = gl::add(t2, t4);
    b[k][3] = t4;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t total = gl::add(gl::add(b[0][j], b[1][j]), b[2][j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) el[4 * k + j] = gl::add(b[k][j], total);
  }
}

__device__ __forceinline__ void full_round(uint64_t* el, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) el[i] = sbox7(gl::add(el[i], c_rc[r * WIDTH + i]));
  external_mds(el);
}

__device__ __forceinline__ void partial_round(uint64_t* el, int r) {
  el[0] = sbox7(gl::add(el[0], c_rc[r * WIDTH]));
  uint64_t total = el[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) total = gl::add(total, el[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) el[i] = gl::add(gl::mul(el[i], c_diag[i]), total);
}

__global__ void __launch_bounds__(THREADS)
poseidon2_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                 long long b) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= b) return;
  uint64_t el[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) el[i] = in[i * b + t];
  external_mds(el);
  int r = 0;
  for (int k = 0; k < HALF_FULL; ++k, ++r) full_round(el, r);
  for (int k = 0; k < PARTIAL; ++k, ++r) partial_round(el, r);
  for (int k = 0; k < HALF_FULL; ++k, ++r) full_round(el, r);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[i * b + t] = el[i];
}

}  // namespace

// Copies the round constants (30 x 12, canonical) and the 12 diagonal
// factors 2^shift[i] into constant memory; call once before the first launch.
extern "C" int poseidon2_set_constants(const void* rc, const void* diag) {
  cudaError_t err = cudaMemcpyToSymbol(c_rc, rc, sizeof(uint64_t) * ROUNDS * WIDTH);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_diag, diag, sizeof(uint64_t) * WIDTH);
}

// in, out: (12, b) element-major canonical states; in and out may not alias.
extern "C" int poseidon2_permute(const void* in, void* out, long long b,
                                 void* stream) {
  if (b <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((b + THREADS - 1) / THREADS);
  poseidon2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, b);
  return (int)cudaGetLastError();
}
