// Poseidon2 (Goldilocks, width 12) for the Merkle trees: four entry points
// on one permutation.
//   poseidon2_permute      (12, B) states -> (12, B) permuted states
//   poseidon2_leaf_hashes  (k, m) leaf columns -> (4, m) leaf hashes
//   poseidon2_node_layers  (4, m) node layer -> every layer above it down to
//                          the cap, one or two launches a tree
//   poseidon2_node_layer   (4, m) node layer -> (4, m/2) parent layer
//
// Replaces the TPU kernel boojum_tpu/hash/pallas_poseidon2.py:_kernel, and
// for the leaf and node entries also the loop around it in
// boojum_tpu/prover/device_merkle.py (_leaf_hashes_traced, a lax.scan of one
// permutation per rate-8 block, and _node_layer_traced, a layer).
// Rounds: external MDS; 4 full rounds (round constants, x^7 s-box on every
// element, external MDS = M4 inside the block circulant
// [[2,1,1],[1,2,1],[1,1,2]]); 22 partial rounds (constant and s-box on
// element 0, then el[i]*2^shift[i] + sum(el)); 4 more full rounds.
//
// Bound: operations. A permutation reads and writes 192 bytes against 472
// s-box field multiplies (8 full rounds x 12 x 4, 22 partial rounds x 4),
// each at least 4 32-bit integer multiply-adds. What the compiled code
// issues is far more (about 18,500 instructions a permutation: 10,300 on
// the ALU pipe, 7,400 IMAD on the FMA pipe, 64 lanes an SM each), and the
// ALU pipe's share bounds it at 2.58 ms at (64, 2^19) against 3.78 ms
// measured (scripts/torch_poseidon_tree_compare.py --poseidon2).
//
// Design: one thread a state, its 12 elements in registers; lazy
// representatives (any uint64_t, goldilocks.cuh) between rounds and between
// absorbed blocks, each output element canonicalized once, at the store.
// Since every lazy step is exact mod p, the outputs are bit-identical to the
// canonical chain. The s-box squares for x^2 and x^4 (3 partial products,
// not 4) and reduces each 128-bit product with one signed carry fix. The
// linear layers reduce late: the external MDS sums the M4 chain and the
// circulant in 128-bit integers (< 2^71) and the internal matrix adds
// el[i] * 2^shift[i] (a shift) to the 128-bit sum of the state, each
// output reduced once from below 2^96; a partial round sums the elements
// other than element 0 before that element's s-box, off its chain. The
// shifts are compile-time constants, checked against the host's table by
// poseidon2_set_constants; the round constants sit in __constant__ memory.
// The round loops stay rolled: unrolling all 30 rounds made a kernel five
// times larger that ran slower from the instruction cache. Each kernel has
// two builds (ROLL), picked by the entry points by launch width:
// - rolled, from ROLL_FROM permutations side by side: a full round's 12
//   s-boxes in a rolled loop of three blocks of 4, a loop body half the
//   size (11 KB against 23 KB), 7-9 % faster at the widest leaves, where
//   the warps of an SM share its instruction cache;
// - unrolled, below it: all 12 s-boxes a round side by side, the shorter
//   chain for a launch of few warps (the rolled build was 4 % slower at
//   the prove's small leaf launches).
// The leaf entry absorbs the k/8 rate blocks of a column in overwrite mode
// with the state kept in registers between permutations (rows past k read
// as zero, as the padding to the rate would give), its rows at a row stride
// ld >= m, so a strided view of an oracle needs no copy. The node layer
// entry reads each sibling pair as one 16-byte load per element row and
// zeroes the capacity in registers. Every layout is element-major, so
// neighbouring threads read and write neighbouring addresses. Tried and
// dropped (measured in turns): the linear layers on 32-bit halves as
// IMAD.WIDE.U32 with the next round's constants folded in (+3,000 IMAD and
// no fewer ALU instructions a permutation, 38 % slower), more registers (4
// or 3 blocks an SM: the rolled build needs 70), two partial rounds a
// reduction (1 % faster, more code), 6 turns of 2 s-boxes.
//
// A tree's node layers (poseidon2_node_layers) take csrc/byte_tree.cuh's
// schedule: 256 threads a block hash 3-level subtrees in shared memory and
// hand on, one launch a tree, two above 2^17 nodes. A wide tree's first
// launch (one stage, from ROLL_FROM parents) takes the rolled build and
// one thread a state. Every other launch is bound by latency: its top
// levels have few parents, and each level waits a permutation. There the
// unrolled build hashes the narrow levels (at most 64 parents a block) on 4
// neighbouring lanes a state (`Lanes`, the node hash's opt-in to
// byte_tree's narrow levels): lane j holds elements j, 4 + j and 8 + j, so
// the block circulant stays inside a lane and a full round's three s-boxes
// a lane run side by side; M4 takes the other lanes' elements by warp
// shuffles and sums 32-bit halves as IMAD.WIDE.U32, and a partial round
// sums the other elements across the 4 lanes (two shuffle steps) while lane
// 0 runs the s-box, then takes lane 0's output by one shuffle. A narrow
// level takes about 12.5 us against 23 us on one thread.
#include <cstdint>
#include <cuda_runtime.h>

#include "byte_tree.cuh"
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
// blocks of byte_tree::THREADS per SM for the node layers: up to 80
// registers (2, up to 128, was slower for a 2^19-leaf tree)
constexpr int NODE_MIN_BLOCKS = 3;
constexpr int SHIFTS[WIDTH] = {4, 14, 11, 8, 0, 5, 2, 9, 13, 6, 3, 12};

__constant__ uint64_t c_rc[ROUNDS * WIDTH];
// the same table in device memory, for the lanes' per-lane reads
__device__ uint64_t g_rc[ROUNDS * WIDTH];
// The 4-lane linear layers' factors, read from constant memory so that a
// half-term stays one IMAD: M4 by rows, then 2^SHIFTS, then 1.
constexpr uint32_t M4[16] = {5, 7, 1, 3, 4, 6, 1, 1, 1, 3, 5, 7, 1, 1, 4, 6};
constexpr int DIAG_AT = 16, ONE_AT = DIAG_AT + WIDTH;
__constant__ uint32_t c_mul[ONE_AT + 1] = {
    M4[0], M4[1], M4[2], M4[3], M4[4], M4[5], M4[6], M4[7], M4[8], M4[9],
    M4[10], M4[11], M4[12], M4[13], M4[14], M4[15],
    1u << SHIFTS[0], 1u << SHIFTS[1], 1u << SHIFTS[2], 1u << SHIFTS[3],
    1u << SHIFTS[4], 1u << SHIFTS[5], 1u << SHIFTS[6], 1u << SHIFTS[7],
    1u << SHIFTS[8], 1u << SHIFTS[9], 1u << SHIFTS[10], 1u << SHIFTS[11],
    1u};

// a * b + c, 32 x 32 -> 64 bits plus 64: one IMAD.WIDE.U32.
__device__ __forceinline__ uint64_t mad(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// a * b + c mod 2^64 for a 64-bit a: the low half's IMAD.WIDE.U32 and one
// IMAD of the high half into the high word.
__device__ __forceinline__ uint64_t mad64(uint64_t a, uint32_t b, uint64_t c) {
  const uint64_t d = mad((uint32_t)a, b, c);
  const uint32_t hi = (uint32_t)(d >> 32) + (uint32_t)(a >> 32) * b;
  return ((uint64_t)hi << 32) | (uint32_t)d;
}

// Half h (0: low, 1: high 32 bits) of x.
__device__ __forceinline__ uint32_t half(uint64_t x, int h) {
  return h ? (uint32_t)(x >> 32) : (uint32_t)x;
}

// lo + hi * 2^32 (< 2^96) -> a lazy representative.
__device__ __forceinline__ uint64_t reduce_halves(uint64_t lo, uint64_t hi) {
  return gl::reduce96(((gl::u128)hi << 32) + lo);
}

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

// Full round r: constants and s-boxes, then the external MDS. With ROLL the
// s-boxes go a block of 4 elements at a time, in a rolled loop that brings
// the next block to el[0 .. 3] (three turns put every block back in place):
// a loop body half the size, faster where many warps share an SM's
// instruction cache; without, all 12 unrolled, a shorter chain for a launch
// of few warps.
template <bool ROLL>
__device__ __forceinline__ void full_round(uint64_t* el, int r) {
  if constexpr (ROLL) {
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        el[i] = sbox7(gl::add_canon_lazy(el[i], c_rc[r * WIDTH + 4 * k + i]));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t t = el[i];
        el[i] = el[4 + i];
        el[4 + i] = el[8 + i];
        el[8 + i] = t;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i)
      el[i] = sbox7(gl::add_canon_lazy(el[i], c_rc[r * WIDTH + i]));
  }
  external_mds(el);
}

__device__ __forceinline__ void partial_round(uint64_t* el, int r) {
  // the other elements' sum first: it does not wait for the s-box
  gl::u128 rest = el[1];
#pragma unroll
  for (int i = 2; i < WIDTH; ++i) rest += el[i];
  el[0] = sbox7(gl::add_canon_lazy(el[0], c_rc[r * WIDTH]));
  diag_term<0>(el, rest + el[0]);
}

// The permutation on lazy representatives in, lazy representatives out.
template <bool ROLL>
__device__ __forceinline__ void permute(uint64_t* el) {
  external_mds(el);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round<ROLL>(el, r);
#pragma unroll 1
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; ++r) partial_round(el, r);
#pragma unroll 1
  for (int r = HALF_FULL + PARTIAL; r < ROUNDS; ++r) full_round<ROLL>(el, r);
}

// ---------------------------------------------------------------------------
// One state on 4 neighbouring lanes (the narrow levels of the node layers).
// Lane j holds x[k] = el[4k + j], k = 0, 1, 2; every lane of the warp takes
// part. Round r's constants of the lane's elements are read from g_rc one
// round ahead (per-lane addresses: device memory, not __constant__).
// ---------------------------------------------------------------------------

constexpr int STATE_LANES = 4;

struct Lanes {
  int j;
  uint32_t diag[3];   // 2^SHIFTS[4k + j]
  uint32_t coef[4];   // M4[j][j ^ m]: the factor of lane j ^ m's element

  __device__ __forceinline__ uint64_t xor_lane(uint64_t v, int m) const {
    const uint32_t lo = __shfl_xor_sync(~0u, (uint32_t)v, m, STATE_LANES);
    const uint32_t hi =
        __shfl_xor_sync(~0u, (uint32_t)(v >> 32), m, STATE_LANES);
    return ((uint64_t)hi << 32) | lo;
  }

  // Lane 0's v, on every lane of the state.
  __device__ __forceinline__ uint64_t from_lane0(uint64_t v) const {
    const uint32_t lo = __shfl_sync(~0u, (uint32_t)v, 0, STATE_LANES);
    const uint32_t hi = __shfl_sync(~0u, (uint32_t)(v >> 32), 0, STATE_LANES);
    return ((uint64_t)hi << 32) | lo;
  }

  // The external MDS: the lane's outputs
  // out_k[j] = (M4 x_k)[j] + (M4 s)[j], s = x_0 + x_1 + x_2, from every
  // lane's elements (y[m][k] = x_k of lane j ^ m) on 32-bit halves.
  __device__ __forceinline__ void mds(uint64_t* x) const {
    uint64_t y[4][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) y[0][k] = x[k];
#pragma unroll
    for (int m = 1; m < 4; ++m)
#pragma unroll
      for (int k = 0; k < 3; ++k) y[m][k] = xor_lane(x[k], m);
    uint64_t acc[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint64_t t = 0;  // (M4 s)[j]
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint64_t s =
            mad(half(y[m][2], h), c_mul[ONE_AT],
                mad(half(y[m][1], h), c_mul[ONE_AT], half(y[m][0], h)));
        t = mad64(s, coef[m], t);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint64_t a = t;
#pragma unroll
        for (int m = 0; m < 4; ++m) a = mad(half(y[m][k], h), coef[m], a);
        acc[h][k] = a;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = reduce_halves(acc[0][k], acc[1][k]);
  }

  // The lane's 3 round constants of round r.
  __device__ __forceinline__ void constants(int r, uint64_t* c) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = __ldg(g_rc + r * WIDTH + 4 * k + j);
  }

  // A full round: constants, the s-boxes, the MDS; the next round's
  // constants loaded meanwhile into c.
  __device__ __forceinline__ void full_round(uint64_t* x, uint64_t* c,
                                             int r) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = gl::add_canon_lazy(x[k], c[k]);
    if (r + 1 < ROUNDS) constants(r + 1, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = sbox7(x[k]);
    mds(x);
  }

  __device__ __forceinline__ void permute(uint64_t* x) const {
    uint64_t c[3];
    constants(0, c);
    mds(x);
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) full_round(x, c, r);
    // the partial rounds: the sum of every element but element 0 over the
    // lanes' halves first (it does not wait for the s-box), then constant
    // and s-box on element 0 (lane 0's x[0]; every lane computes one and
    // takes lane 0's), the sum completed, and each element times its
    // 2^shift plus the sum
#pragma unroll 1
    for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; ++r) {
      uint64_t tot[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t a = mad(half(x[2], h), c_mul[ONE_AT],
                         mad(half(x[1], h), c_mul[ONE_AT],
                             j == 0 ? 0 : half(x[0], h)));
        a += xor_lane(a, 1);
        tot[h] = a + xor_lane(a, 2);
      }
      const uint64_t y0 =
          sbox7(gl::add_canon_lazy(x[0], j == 0 ? c_rc[r * WIDTH] : 0));
      const uint64_t y = from_lane0(y0);
      x[0] = j == 0 ? y0 : x[0];
#pragma unroll
      for (int h = 0; h < 2; ++h) tot[h] += half(y, h);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        x[k] = reduce_halves(mad(half(x[k], 0), diag[k], tot[0]),
                             mad(half(x[k], 1), diag[k], tot[1]));
    }
    constants(HALF_FULL + PARTIAL, c);
#pragma unroll 1
    for (int r = HALF_FULL + PARTIAL; r < ROUNDS; ++r) full_round(x, c, r);
  }
};

__device__ __forceinline__ Lanes lanes_of(int j) {
  Lanes ln;
  ln.j = j;
#pragma unroll
  for (int k = 0; k < 3; ++k) ln.diag[k] = c_mul[DIAG_AT + 4 * k + j];
#pragma unroll
  for (int m = 0; m < 4; ++m) ln.coef[m] = c_mul[4 * j + (j ^ m)];
  return ln;
}

template <bool ROLL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               long long b) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= b) return;
  uint64_t el[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) el[i] = in[i * b + t];
  permute<ROLL>(el);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[i * b + t] = gl::canonicalize(el[i]);
}

// cols: k rows of m leaf elements, row r at cols + r * ld; out: (4, m).
template <bool ROLL>
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
    permute<ROLL>(el);
  }
#pragma unroll
  for (int i = 0; i < CAP; ++i) out[i * m + t] = gl::canonicalize(el[i]);
}

// cur: (4, 2 * half) nodes, 16-byte aligned; out: (4, half) parents.
template <bool ROLL>
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
  permute<ROLL>(el);
#pragma unroll
  for (int i = 0; i < CAP; ++i) out[i * half + t] = gl::canonicalize(el[i]);
}

// byte_tree's node hash: the digest is 4 elements, the state
// left ‖ right ‖ 0. The unrolled build (a launch bound by latency) hashes
// narrow levels on 4 lanes a state (Lanes), lane j holding word j of each
// child and returning word j of the parent; the rolled build (a wide tree's
// first launch, bound by issue) keeps one thread a state throughout.
template <bool ROLL>
struct NodeHash {
  static constexpr int WORDS = CAP;
  static constexpr int LANES = ROLL ? 1 : STATE_LANES;
  using Word = uint64_t;
  __device__ __forceinline__ void operator()(const uint64_t in[2 * CAP],
                                             uint64_t h[CAP]) const {
    uint64_t el[WIDTH];
#pragma unroll
    for (int i = 0; i < RATE; ++i) el[i] = in[i];
#pragma unroll
    for (int i = RATE; i < WIDTH; ++i) el[i] = 0;
    permute<ROLL>(el);
#pragma unroll
    for (int i = 0; i < CAP; ++i) h[i] = gl::canonicalize(el[i]);
  }
  __device__ __forceinline__ uint64_t lanes(uint64_t left, uint64_t right,
                                            int lane) const {
    uint64_t x[3] = {left, right, 0};
    lanes_of(lane).permute(x);
    return gl::canonicalize(x[0]);
  }
};

template <bool ROLL>
__global__ void __launch_bounds__(byte_tree::THREADS, NODE_MIN_BLOCKS)
nodes_kernel(const uint64_t* cur, uint64_t* out, long long m, int levels,
             unsigned* tickets) {
  byte_tree::node_tree(cur, out, m, levels, tickets, NodeHash<ROLL>());
}

unsigned grid_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// Whether a launch of n one-thread permutations side by side takes the
// rolled full rounds (ROLL): from ROLL_FROM on the instruction cache, below
// it a warp's chain bounds the time.
constexpr long long ROLL_FROM = 1LL << 16;
bool rolled(long long n) { return n >= ROLL_FROM; }

}  // namespace

// Copies the round constants (30 x 12, canonical) into constant and device
// memory and checks the host's 12 internal-matrix shifts against the
// compiled ones; call once per device before the first launch.
extern "C" int poseidon2_set_constants(const void* rc, const void* shifts) {
  const long long* s = (const long long*)shifts;
  for (int i = 0; i < WIDTH; ++i)
    if (s[i] != SHIFTS[i]) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(uint64_t) * ROUNDS * WIDTH;
  const cudaError_t err = cudaMemcpyToSymbol(c_rc, rc, bytes);
  return (int)(err != cudaSuccess ? err : cudaMemcpyToSymbol(g_rc, rc, bytes));
}

// in, out: (12, b) element-major states; in and out may not alias.
extern "C" int poseidon2_permute(const void* in, void* out, long long b,
                                 void* stream) {
  if (b <= 0) return (int)cudaErrorInvalidValue;
  (rolled(b) ? permute_kernel<true> : permute_kernel<false>)
      <<<grid_for(b), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint64_t*)in, (uint64_t*)out, b);
  return (int)cudaGetLastError();
}

// cols: k rows of m elements at a row stride of ld >= m; out: (4, m).
extern "C" int poseidon2_leaf_hashes(const void* cols, void* out, int k,
                                     long long m, long long ld, void* stream) {
  if (k < 0 || m <= 0 || ld < m) return (int)cudaErrorInvalidValue;
  (rolled(m) ? leaf_kernel<true> : leaf_kernel<false>)
      <<<grid_for(m), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint64_t*)cols, (uint64_t*)out, k, m, ld);
  return (int)cudaGetLastError();
}

// cur: (4, m), m even, 16-byte aligned; out: (4, m / 2).
extern "C" int poseidon2_node_layer(const void* cur, void* out, long long m,
                                    void* stream) {
  if (m <= 0 || m % 2 || (uintptr_t)cur % 16) return (int)cudaErrorInvalidValue;
  (rolled(m / 2) ? node_kernel<true> : node_kernel<false>)
      <<<grid_for(m / 2), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint64_t*)cur, (uint64_t*)out, m / 2);
  return (int)cudaGetLastError();
}

// cur: (4, m), m a multiple of 2^levels, 16-byte aligned; out receives the
// `levels` layers above it one after the other, (4, m / 2), (4, m / 4), ...;
// tickets: byte_tree's zeroed hand-on counters.
extern "C" int poseidon2_node_layers(const void* cur, void* out, long long m,
                                     int levels, void* tickets, void* stream) {
  if (!byte_tree::valid(m, levels) || (uintptr_t)cur % 16)
    return (int)cudaErrorInvalidValue;
  const bool wide = rolled(m / 2) && levels <= byte_tree::STAGE;
  (wide ? nodes_kernel<true> : nodes_kernel<false>)
      <<<byte_tree::grid(m), byte_tree::THREADS, 0, (cudaStream_t)stream>>>(
          (const uint64_t*)cur, (uint64_t*)out, m, levels,
          (unsigned*)tickets);
  return (int)cudaGetLastError();
}
