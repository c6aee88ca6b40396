// Poseidon (Goldilocks, width 12, the classic permutation of the Poseidon
// transcript) on ONE sponge state: the device transcript's absorb and
// squeeze. Two entry points:
//   poseidon_absorb   state (12,), elements (k,) -> state (12,): append the
//                     1-then-zeros pad to a multiple of RATE = 8 (k + 1
//                     counted), then per rate block overwrite state[0..8)
//                     and permute; all blocks in one launch
//   poseidon_permute  state (12,) -> permuted state (12,)
//
// Replaces the permutation inside boojum_tpu/prover/device_transcript.py
// _flush_jit (:87, its pad and block scan too), _perm_jit (:123) and
// _ext_extract_cross_jit (:145); the permutation is
// boojum_tpu/hash/poseidon.py _permutation_rolled_gl (:76). No TPU kernel
// stands behind it (XLA compiles each of those into one program), but a
// torch transcription costs thousands of launches per permutation.
//
// Rounds (boojum_tpu_torch/hash/poseidon.py permutation_stacked): 4 full
// rounds (round constants, x^7 s-box on every element, MDS), 22 partial
// rounds (constants, s-box on element 0, MDS), 4 full rounds. The MDS is the
// circulant MDS[r][c] = 2^EXPS[(12 - r + c) % 12], exponents <= 16.
//
// Bound: the dependency chain. The k elements are absorbed one rate block
// after another and each permutation is 30 dependent rounds; the bytes
// (8 (k + 24)) and the operations (8 * 12 * 4 + 22 * 4 field multiplies a
// permutation) are tiny beside it.
//
// Design: one warp, lane i < 12 holds state element i. A round adds the
// constant, applies the s-box (every lane in a full round, lane 0 in a
// partial one), then each lane gathers the 12 elements by warp shuffles and
// sums its MDS row as a 128-bit integer of shifted terms (< 2^84), reduced
// once. All arithmetic is canonical (goldilocks.cuh add / mul, reduce96 then
// canon). The round constants and exponents come in a device table that the
// wrapper uploads once, staged in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12, RATE = 8, HALF_FULL = 4, PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int TABLE = ROUNDS * WIDTH + WIDTH;  // constants, then exponents

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x3 = gl::mul(x, x2);
  const uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(x3, x4);
}

// One permutation; lane i < WIDTH holds element i, the other lanes follow
// along for the shuffles.
__device__ uint64_t permute_lanes(uint64_t s, int lane, const uint64_t* rc,
                                  const int* exps) {
  const int row = lane < WIDTH ? lane : 0;
  for (int r = 0; r < ROUNDS; ++r) {
    const bool full = r < HALF_FULL || r >= HALF_FULL + PARTIAL;
    s = gl::add(s, rc[r * WIDTH + row]);
    if (full || lane == 0) s = sbox7(s);
    gl::u128 acc = 0;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
      const uint64_t v =
          __shfl_sync(0xffffffffu, (unsigned long long)s, c);
      acc += (gl::u128)v << exps[(WIDTH - row + c) % WIDTH];
    }
    s = gl::canon(gl::reduce96(acc));
  }
  return s;
}

__device__ __forceinline__ void load_table(const uint64_t* table,
                                           uint64_t* rc, int* exps) {
  for (int i = threadIdx.x; i < ROUNDS * WIDTH; i += 32) rc[i] = table[i];
  if (threadIdx.x < WIDTH)
    exps[threadIdx.x] = (int)table[ROUNDS * WIDTH + threadIdx.x];
  __syncwarp();
}

__global__ void __launch_bounds__(32)
absorb_kernel(const uint64_t* __restrict__ st_in,
              const uint64_t* __restrict__ elems, long long k,
              uint64_t* __restrict__ st_out,
              const uint64_t* __restrict__ table) {
  __shared__ uint64_t rc[ROUNDS * WIDTH];
  __shared__ int exps[WIDTH];
  load_table(table, rc, exps);
  const int lane = threadIdx.x;
  uint64_t s = lane < WIDTH ? st_in[lane] : 0;
  const long long nblocks = (k + RATE) / RATE;  // ceil((k + 1) / RATE)
  for (long long blk = 0; blk < nblocks; ++blk) {
    if (lane < RATE) {
      const long long i = blk * RATE + lane;
      s = i < k ? gl::canon(elems[i]) : (i == k ? 1 : 0);
    }
    s = permute_lanes(s, lane, rc, exps);
  }
  if (lane < WIDTH) st_out[lane] = s;
}

__global__ void __launch_bounds__(32)
permute_kernel(const uint64_t* __restrict__ st_in,
               uint64_t* __restrict__ st_out,
               const uint64_t* __restrict__ table) {
  __shared__ uint64_t rc[ROUNDS * WIDTH];
  __shared__ int exps[WIDTH];
  load_table(table, rc, exps);
  const int lane = threadIdx.x;
  uint64_t s = lane < WIDTH ? st_in[lane] : 0;
  s = permute_lanes(s, lane, rc, exps);
  if (lane < WIDTH) st_out[lane] = s;
}

}  // namespace

// state, out: (12,) canonical; elems: (k,), k >= 0; table: TABLE u64 (round
// constants round-major, then the 12 MDS exponents). out may not alias.
extern "C" int poseidon_absorb(const void* state, const void* elems,
                               long long k, void* out, const void* table,
                               void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  absorb_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)state, (const uint64_t*)elems, k, (uint64_t*)out,
      (const uint64_t*)table);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_permute(const void* state, void* out,
                                const void* table, void* stream) {
  permute_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)state, (uint64_t*)out, (const uint64_t*)table);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_table_size() { return TABLE; }
