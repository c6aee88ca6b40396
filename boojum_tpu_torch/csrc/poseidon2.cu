// Poseidon2 (Goldilocks, width 12) for the Merkle trees: three entry points
// on one permutation.
//   poseidon2_permute      (12, B) states -> (12, B) permuted states
//   poseidon2_leaf_hashes  (k, m) leaf columns -> (4, m) leaf hashes
//   poseidon2_node_layer   (4, m) node layer -> (4, m/2) parent layer
//
// Replaces the TPU kernel boojum_tpu/hash/pallas_poseidon2.py:_kernel, and
// for the leaf and node entries also the loop around it in
// boojum_tpu/prover/device_merkle.py (_leaf_hashes_traced, a lax.scan of one
// permutation per rate-8 block, and _node_layer_traced).
// Rounds: external MDS; 4 full rounds (round constants, x^7 s-box on every
// element, external MDS = M4 addition chains inside the block circulant
// [[2,1,1],[1,2,1],[1,1,2]]); 22 partial rounds (constant and s-box on
// element 0, then el[i]*2^shift[i] + sum(el)); 4 more full rounds.
//
// Bound: operations. A permutation reads and writes 192 bytes against 472
// s-box field multiplies (8 full rounds x 12 x 4, 22 partial rounds x 4),
// each at least 4 32-bit integer multiply-adds.
//
// Design, as the TPU kernel does it: every round works on lazy
// representatives (any uint64_t, goldilocks.cuh), and each output element is
// canonicalized once, at the store; since every lazy step is exact mod p the
// outputs are bit-identical to the canonical chain. The s-box squares for x^2
// and x^4 (3 partial products, not 4) and reduces each 128-bit product with
// one signed carry fix. The linear layers reduce late: the external MDS sums
// the M4 chain and the circulant in 128-bit integers (< 2^71) and the
// internal matrix adds el[i] * 2^shift[i] (a shift, no multiply) to the
// 128-bit sum of the state, each output reduced once from below 2^96. The
// shifts are compile-time constants, checked against the host's table by
// poseidon2_set_constants; the round constants sit in __constant__ memory.
// Each round's body is unrolled and the round loops are not. One thread per
// state, its 12 elements in registers; the launch bounds ask for 6 blocks of
// 128 threads per SM, at most 80 registers a thread. The permute entry fits
// in 72 registers with no spill; the leaf and node entries take 79-80 and
// spill 8 bytes (`-Xptxas -v`). At 8 blocks (64 registers) the kernel
// spilled 16 bytes and ran 3 % slower. Every layout is
// element-major, so neighbouring threads read and write neighbouring
// addresses. The leaf entry absorbs the k/8 rate blocks of a column in
// overwrite mode with the state kept in registers between permutations (rows
// past k read as zero, as the padding to the rate would give); the node entry
// reads each sibling pair as one 16-byte load per element row and zeroes the
// capacity in registers. So a tree costs one launch per layer, and device
// memory sees each input read once and each output written once.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int CAP = 4;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 6;  // 6 x 128 threads per SM: up to 80 registers
constexpr int SHIFTS[WIDTH] = {4, 14, 11, 8, 0, 5, 2, 9, 13, 6, 3, 12};

__constant__ uint64_t c_rc[ROUNDS * WIDTH];

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl::square_lazy(x);
  const uint64_t x3 = gl::mul_lazy(x, x2);
  const uint64_t x4 = gl::square_lazy(x2);
  return gl::mul_lazy(x3, x4);
}

// The external MDS with delayed reduction: each output is a sum of the 12
// inputs with coefficients below 2^7, so the M4 chain and the circulant run
// on 128-bit sums (< 2^71) and each output is reduced once.
__device__ __forceinline__ void external_mds(uint64_t* el) {
  using gl::u128;
  u128 b[3][4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const u128 x0 = el[4 * k], x1 = el[4 * k + 1];
    const u128 x2 = el[4 * k + 2], x3 = el[4 * k + 3];
    const u128 t0 = x0 + x1;
    const u128 t1 = x2 + x3;
    const u128 t2 = (x1 << 1) + t1;
    const u128 t3 = (x3 << 1) + t0;
    const u128 t4 = (t1 << 2) + t3;
    const u128 t5 = (t0 << 2) + t2;
    b[k][0] = t3 + t5;
    b[k][1] = t5;
    b[k][2] = t2 + t4;
    b[k][3] = t4;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const u128 total = b[0][j] + b[1][j] + b[2][j];
#pragma unroll
    for (int k = 0; k < 3; ++k) el[4 * k + j] = gl::reduce96(b[k][j] + total);
  }
}

// el[i] = el[i] * 2^SHIFTS[i] + sum(el), the shifts as template arguments;
// el[i] * 2^14 + sum < 2^79, reduced once.
template <int I>
__device__ __forceinline__ void diag_term(uint64_t* el, gl::u128 total) {
  constexpr int S = SHIFTS[I];
  el[I] = gl::reduce96(((gl::u128)el[I] << S) + total);
  if constexpr (I + 1 < WIDTH) diag_term<I + 1>(el, total);
}

__device__ __forceinline__ void full_round(uint64_t* el, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i)
    el[i] = sbox7(gl::add_canon_lazy(el[i], c_rc[r * WIDTH + i]));
  external_mds(el);
}

__device__ __forceinline__ void partial_round(uint64_t* el, int r) {
  el[0] = sbox7(gl::add_canon_lazy(el[0], c_rc[r * WIDTH]));
  gl::u128 total = el[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) total += el[i];
  diag_term<0>(el, total);
}

// The permutation on lazy representatives in, lazy representatives out. The
// round loops stay rolled (each round's body is unrolled): unrolling all 30
// rounds made a kernel five times larger that ran slower from the
// instruction cache and took minutes to compile.
__device__ __forceinline__ void permute(uint64_t* el) {
  external_mds(el);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round(el, r);
#pragma unroll 1
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; ++r) partial_round(el, r);
#pragma unroll 1
  for (int r = HALF_FULL + PARTIAL; r < ROUNDS; ++r) full_round(el, r);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               long long b) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= b) return;
  uint64_t el[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) el[i] = in[i * b + t];
  permute(el);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[i * b + t] = gl::canonicalize(el[i]);
}

// cols: k rows of m leaf elements, row r at cols + r * ld; out: (4, m).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
leaf_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
            int k, long long m, long long ld) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= m) return;
  uint64_t el[WIDTH] = {};
  for (int r0 = 0; r0 < k; r0 += RATE) {
    const uint64_t* src = cols + (long long)r0 * ld + t;
#pragma unroll
    for (int i = 0; i < RATE; ++i) el[i] = r0 + i < k ? src[i * ld] : 0;
    permute(el);
  }
#pragma unroll
  for (int i = 0; i < CAP; ++i) out[i * m + t] = gl::canonicalize(el[i]);
}

// cur: (4, 2 * half) nodes, 16-byte aligned; out: (4, half) parents.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
node_kernel(const uint64_t* __restrict__ cur, uint64_t* __restrict__ out,
            long long half) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= half) return;
  uint64_t el[WIDTH];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const ulonglong2 pair =
        reinterpret_cast<const ulonglong2*>(cur + 2 * half * i)[t];
    el[i] = pair.x;        // left sibling
    el[CAP + i] = pair.y;  // right sibling
  }
#pragma unroll
  for (int i = RATE; i < WIDTH; ++i) el[i] = 0;
  permute(el);
#pragma unroll
  for (int i = 0; i < CAP; ++i) out[i * half + t] = gl::canonicalize(el[i]);
}

unsigned grid_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// Copies the round constants (30 x 12, canonical) into constant memory and
// checks the host's 12 internal-matrix shifts against the compiled ones;
// call once per device before the first launch.
extern "C" int poseidon2_set_constants(const void* rc, const void* shifts) {
  const long long* s = (const long long*)shifts;
  for (int i = 0; i < WIDTH; ++i)
    if (s[i] != SHIFTS[i]) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_rc, rc, sizeof(uint64_t) * ROUNDS * WIDTH);
}

// in, out: (12, b) element-major states; in and out may not alias.
extern "C" int poseidon2_permute(const void* in, void* out, long long b,
                                 void* stream) {
  if (b <= 0) return (int)cudaErrorInvalidValue;
  permute_kernel<<<grid_for(b), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, b);
  return (int)cudaGetLastError();
}

// cols: k rows of m elements at a row stride of ld >= m; out: (4, m).
extern "C" int poseidon2_leaf_hashes(const void* cols, void* out, int k,
                                     long long m, long long ld, void* stream) {
  if (k < 0 || m <= 0 || ld < m) return (int)cudaErrorInvalidValue;
  leaf_kernel<<<grid_for(m), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cols, (uint64_t*)out, k, m, ld);
  return (int)cudaGetLastError();
}

// cur: (4, m), m even, 16-byte aligned; out: (4, m / 2).
extern "C" int poseidon2_node_layer(const void* cur, void* out, long long m,
                                    void* stream) {
  if (m <= 0 || m % 2 || (uintptr_t)cur % 16) return (int)cudaErrorInvalidValue;
  node_kernel<<<grid_for(m / 2), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cur, (uint64_t*)out, m / 2);
  return (int)cudaGetLastError();
}
