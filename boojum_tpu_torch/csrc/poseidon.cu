// Poseidon (Goldilocks, width 12, the classic permutation of the Poseidon
// transcript and of the "poseidon" Merkle trees). Two entry points on ONE
// sponge state, the device transcript's absorb and squeeze:
//   poseidon_absorb   state (12,), elements (k,) -> state (12,): append the
//                     1-then-zeros pad to a multiple of RATE = 8 (k + 1
//                     counted), then per rate block overwrite state[0..8)
//                     and permute; all blocks in one launch
//   poseidon_permute  state (12,) -> permuted state (12,)
// and three on m independent sponges, the Merkle tree's hashes (at the end
// of this file, with their own notes and their own round order):
//   poseidon_leaf_hashes  (k, m) leaf columns -> (4, m) leaf hashes
//   poseidon_node_layers  (4, m) node layer -> every layer above it down to
//                         the cap, one or two launches a tree
//   poseidon_node_layer   (4, m) node layer -> (4, m/2) parent layer
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
// (8 (k + 24)) and the operations (472 field multiplies a permutation) are
// tiny beside it. A round's chain is the s-box (three dependent lazy
// multiplies: x^2, then x^3 and x^4, then x^7), the exchange of the state
// between lanes, the MDS sum and its reduction.
//
// Design: one warp of 12 lanes, lane i holds state element i, so a round's
// twelve s-boxes run side by side.
// - Lazy arithmetic (goldilocks.cuh: add_canon_lazy, square_lazy, mul_lazy,
//   reduce96): every value between rounds and between absorbed blocks is
//   any uint64_t congruent to the exact one, and the state is canonicalized
//   once, at the store. The inputs need no canonicalization either.
// - The MDS sum is rotated: lane i computes
//   sum_j s[(i + j) % 12] * 2^EXPS[j], so every shift is a compile-time
//   constant, and the source lanes (i + j) % 12 are computed once, before the
//   rounds. A term is split into its 32-bit halves, and each half sum
//   (< 12 * 2^48) accumulates in 64 bits with one multiply-add a term; one
//   reduce96 per round takes lo + hi * 2^32 (< 2^85).
// - Partial rounds: only lane 0's s-box feeds the MDS, and the other eleven
//   terms are known before it. Each lane sums the terms of lanes 1..11 from
//   the pre-s-box values (lane 0 contributes zero) while lane 0 runs the
//   s-box, then adds lane 0's s-box output times its own power of two (a
//   per-lane constant). The chain of a partial round is then the s-box, one
//   broadcast and one multiply-add, not the s-box and twelve exchanges.
// - The round constants come straight from the device table the wrapper
//   uploads once (2.9 KB: L1 after the first block), each loaded one round
//   ahead; the next rate block's elements are loaded one block ahead.
// The sparse partial-round factorization of the Poseidon paper's appendix
// (Plonky2's mds_partial_layer_fast) is not used here: it trades the
// exchanges for eleven general field multiplies and a reduction across
// lanes, which is no shorter a chain on one warp. The tree entries, bound
// by instruction throughput and not by a chain, use it.
#include <cstdint>
#include <cuda_runtime.h>

#include "byte_tree.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12, RATE = 8, HALF_FULL = 4, PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr unsigned MASK = (1u << WIDTH) - 1;  // the 12 lanes of the warp

// The MDS exponent of term j, a compile-time constant wherever j is (the
// loops over j are unrolled).
__host__ __device__ constexpr int mds_exp(int j) {
  // boojum_tpu_torch/hash/_poseidon_constants.py MDS_MATRIX_EXPS
  constexpr int EXPS[WIDTH] = {0, 0, 1, 0, 3, 5, 1, 8, 12, 3, 16, 10};
  return EXPS[j];
}

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl::square_lazy(x);
  const uint64_t x3 = gl::mul_lazy(x, x2);
  const uint64_t x4 = gl::square_lazy(x2);
  return gl::mul_lazy(x3, x4);
}

// sum_j v[(lane + j) % 12] * 2^EXPS[j] over the lanes' 32-bit halves, added
// to lo, hi; src[j] = (lane + j) % 12. Two accumulators for each half
// halve the chain of multiply-adds behind the last exchange.
__device__ __forceinline__ void mds_terms(uint64_t v, const int* src,
                                          uint64_t& lo, uint64_t& hi) {
  uint64_t lo2 = (uint64_t)(uint32_t)v << mds_exp(0);
  uint64_t hi2 = (v >> 32) << mds_exp(0);
#pragma unroll
  for (int j = 1; j < WIDTH; ++j) {
    const uint32_t l = __shfl_sync(MASK, (uint32_t)v, src[j]);
    const uint32_t h = __shfl_sync(MASK, (uint32_t)(v >> 32), src[j]);
    if (j % 2) {
      lo += (uint64_t)l << mds_exp(j);
      hi += (uint64_t)h << mds_exp(j);
    } else {
      lo2 += (uint64_t)l << mds_exp(j);
      hi2 += (uint64_t)h << mds_exp(j);
    }
  }
  lo += lo2;
  hi += hi2;
}

// lo + hi * 2^32 (< 2^85) -> a lazy representative.
__device__ __forceinline__ uint64_t mds_reduce(uint64_t lo, uint64_t hi) {
  return gl::reduce96(((gl::u128)hi << 32) + lo);
}

// One permutation, lazy in and out; rc is the device table of round
// constants (round-major), lane < WIDTH.
__device__ __forceinline__ uint64_t permute_lanes(uint64_t s, int lane,
                                                  const int* src,
                                                  uint64_t pow0,
                                                  const uint64_t* rc) {
  uint64_t c = __ldg(rc + lane);
  for (int r = 0; r < HALF_FULL; ++r) {
    const uint64_t t = gl::add_canon_lazy(s, c);
    c = __ldg(rc + (r + 1) * WIDTH + lane);
    uint64_t lo = 0, hi = 0;
    mds_terms(sbox7(t), src, lo, hi);
    s = mds_reduce(lo, hi);
  }
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; ++r) {
    const uint64_t t = gl::add_canon_lazy(s, c);
    c = __ldg(rc + (r + 1) * WIDTH + lane);
    const uint64_t y = sbox7(t);  // only lane 0's is used
    uint64_t lo = 0, hi = 0;
    mds_terms(lane == 0 ? 0 : t, src, lo, hi);
    const uint64_t y0 = __shfl_sync(MASK, (unsigned long long)y, 0);
    lo += (uint64_t)(uint32_t)y0 * pow0;
    hi += (y0 >> 32) * pow0;
    s = mds_reduce(lo, hi);
  }
  for (int r = HALF_FULL + PARTIAL; r < ROUNDS; ++r) {
    const uint64_t t = gl::add_canon_lazy(s, c);
    if (r + 1 < ROUNDS) c = __ldg(rc + (r + 1) * WIDTH + lane);
    uint64_t lo = 0, hi = 0;
    mds_terms(sbox7(t), src, lo, hi);
    s = mds_reduce(lo, hi);
  }
  return s;
}

// The lane's loop invariants: its source lanes, and 2^EXPS[j0] for the j0
// at which lane 0 is its source.
__device__ __forceinline__ uint64_t lane_setup(int lane, int* src) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) src[j] = (lane + j) % WIDTH;
  uint64_t pow0 = 0;
#pragma unroll
  for (int j = 0; j < WIDTH; ++j)
    if ((lane + j) % WIDTH == 0) pow0 = 1ull << mds_exp(j);
  return pow0;
}

// Lane ``lane``'s value of rate block ``blk``: an element, the pad's one,
// or zero.
__device__ __forceinline__ uint64_t block_value(const uint64_t* elems,
                                                long long k, long long blk,
                                                int lane) {
  const long long i = blk * RATE + lane;
  return i < k ? __ldg(elems + i) : (i == k ? 1 : 0);
}

__global__ void __launch_bounds__(WIDTH)
absorb_kernel(const uint64_t* __restrict__ st_in,
              const uint64_t* __restrict__ elems, long long k,
              uint64_t* __restrict__ st_out,
              const uint64_t* __restrict__ rc) {
  const int lane = threadIdx.x;
  int src[WIDTH];
  const uint64_t pow0 = lane_setup(lane, src);
  uint64_t s = st_in[lane];
  const long long nblocks = (k + RATE) / RATE;  // ceil((k + 1) / RATE)
  uint64_t next = lane < RATE ? block_value(elems, k, 0, lane) : 0;
  for (long long blk = 0; blk < nblocks; ++blk) {
    if (lane < RATE) {
      s = next;
      if (blk + 1 < nblocks) next = block_value(elems, k, blk + 1, lane);
    }
    s = permute_lanes(s, lane, src, pow0, rc);
  }
  st_out[lane] = gl::canonicalize(s);
}

__global__ void __launch_bounds__(WIDTH)
permute_kernel(const uint64_t* __restrict__ st_in,
               uint64_t* __restrict__ st_out,
               const uint64_t* __restrict__ rc) {
  const int lane = threadIdx.x;
  int src[WIDTH];
  const uint64_t pow0 = lane_setup(lane, src);
  st_out[lane] = gl::canonicalize(
      permute_lanes(st_in[lane], lane, src, pow0, rc));
}

// ---------------------------------------------------------------------------
// The Merkle tree of the "poseidon" tree hasher: m independent sponges.
//
// Replaces no TPU kernel: the reference builds this tree with the batched
// jnp sponge of boojum_tpu/hash/sponge.py (hash_leaves :116, hash_nodes
// :147) behind its host AlgebraicMerkleTree (boojum_tpu/hash/merkle.py:39,
// reached from boojum_tpu/prover/device_merkle.py:332).
// - Leaf: from the all-zero state, each rate block of the column overwrites
//   state[0..8) and is permuted; a partial last block zero-fills the rest of
//   the rate (no 1-then-zeros pad, unlike poseidon_absorb); out state[0..4).
// - Node: the state left ‖ right ‖ 0, one permutation; out state[0..4).
//
// Bound: operations, on the two integer pipes. A permutation reads
// and writes at most 192 bytes against its 472 s-box field multiplies; the
// classic MDS adds a 12 x 12 product in every round.
//
// Design: one thread a state, its 12 elements in registers, lazy arithmetic
// (goldilocks.cuh) between rounds and blocks, one canonicalization a stored
// element; the round loops rolled, each round's body unrolled.
// - Sparse partial rounds (boojum_tpu_torch/hash/poseidon_sparse.py, the
//   Poseidon paper's appendix B): the partial rounds' constants pushed
//   forward leave a scalar k_r on element 0 a round and a residual that
//   joins full round 26's constants; each round's MDS, split as B_r A_r
//   with A_r = diag(1, N_r) moved into the round before, leaves one dense
//   11 x 11 product A_0 before the partial rounds and in each partial round
//   y = sbox(s0 + k_r), s0 = y + sum_i w_r[i] s_i, s_i += v_r[i] y: 22
//   general products a round instead of 144 power-of-two terms. Each
//   output's products collect in a 128-bit sum and a carry count (`Acc`),
//   one reduction an output.
// - Full rounds keep the circulant: output r is
//   sum_c s[c] * 2^EXPS[(12 - r + c) % 12], each term split into its 32-bit
//   halves, each half sum (< 12 * 2^48) in 64 bits, one reduce96 an output.
//   A half-term is one IMAD.WIDE.U32 by 2^e read from constant memory (the
//   FMA pipe), not the compiler's shifts and adds (the ALU pipe), so that
//   the two integer pipes share the work: measured faster at the leaves'
//   widest shapes (scripts/torch_poseidon_tree_compare.py).
// - The constants sit in constant memory: the sparse form's table, copied
//   once a device by poseidon_tree_set_constants, and the MDS's powers of
//   two. Every thread reads the same address.
// - 3 blocks of 128 threads an SM, up to 168 registers: 14 % faster at
//   (93, 2^19) than 4 blocks at 128 registers, which are short of registers
//   for the 12 elements, the products and the accumulators.
// - Leaves take k rows at a row stride ld >= m, so a strided view of the
//   oracle's LDE needs no copy; rows past k read as zero. Nodes read each
//   sibling pair as one 16-byte load a state row.
// - A tree's node layers: poseidon_node_layers, one or two launches a tree
//   (byte_tree.cuh, the schedule the byte trees use; 256 threads, 3 levels a
//   stage, 8 KB of shared memory for the parents). poseidon_node_layer, one
//   launch a layer, stays for the sharded trees.
// ---------------------------------------------------------------------------

constexpr int CAP = 4;
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;  // 3 x 128 threads per SM: up to 168 registers
// blocks of byte_tree::THREADS per SM for the node layers: up to 128
// registers
constexpr int NODE_MIN_BLOCKS = 2;

// poseidon_sparse.py's table: the 8 full rounds' constants, A_0 by rows,
// then each partial round's k, w (11) and v (11)
constexpr int FULL_SIZE = 2 * HALF_FULL * WIDTH;
constexpr int A0_SIZE = (WIDTH - 1) * (WIDTH - 1);
constexpr int PARTIAL_STRIDE = 23;
constexpr int PARTIAL_AT = FULL_SIZE + A0_SIZE;
constexpr int TABLE_SIZE = PARTIAL_AT + PARTIAL * PARTIAL_STRIDE;

__constant__ uint64_t c_tree[TABLE_SIZE];
// 2^EXPS[j]: read, not folded, so that a half-term is one IMAD
__constant__ uint32_t c_pow2[WIDTH] = {
    1u << mds_exp(0), 1u << mds_exp(1), 1u << mds_exp(2), 1u << mds_exp(3),
    1u << mds_exp(4), 1u << mds_exp(5), 1u << mds_exp(6), 1u << mds_exp(7),
    1u << mds_exp(8), 1u << mds_exp(9), 1u << mds_exp(10),
    1u << mds_exp(11)};

// acc + half * 2^EXPS[j], half < 2^32: one IMAD.WIDE.U32.
__device__ __forceinline__ uint64_t mds_term(uint64_t acc, uint32_t half,
                                             int j) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;"
      : "=l"(d) : "r"(half), "r"(c_pow2[j]), "l"(acc));
  return d;
}

// The circulant on one thread's state, lazy in and out.
__device__ __forceinline__ void mds_regs(uint64_t* s) {
  uint64_t out[WIDTH];
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
      const int j = (WIDTH - r + c) % WIDTH;
      lo = mds_term(lo, (uint32_t)s[c], j);
      hi = mds_term(hi, (uint32_t)(s[c] >> 32), j);
    }
    out[r] = mds_reduce(lo, hi);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) s[r] = out[r];
}

// A sum of up to 2^32 128-bit products: lo + hi * 2^64 + top * 2^128.
struct Acc {
  uint64_t lo, hi;
  uint32_t top;

  // += x * w
  __device__ __forceinline__ void mac(uint64_t x, uint64_t w) {
    const gl::u128 p = (gl::u128)x * w;
    asm("add.cc.u64 %0, %0, %3;\n\t"
        "addc.cc.u64 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(lo), "+l"(hi), "+r"(top)
        : "l"((uint64_t)p), "l"((uint64_t)(p >> 64)));
  }

  // A lazy representative, for top <= 15: with 2^64 = 2^32 - 1,
  // 2^96 = -1 and 2^128 = -2^32 (mod p), V = lo + hi_lo * 2^32 - hi_lo -
  // hi_hi - top * 2^32 lies in (-2^64, 2^65), so its carry out of 64 bits
  // is -1, 0 or 1 (as in gl::reduce128_lazy).
  __device__ __forceinline__ uint64_t reduce() const {
    const uint64_t hi_hi = hi >> 32, hi_lo = hi & gl::EPS;
    const gl::u128 w = (gl::u128)lo + (hi_lo << 32) -
                       (hi_lo + hi_hi + ((uint64_t)top << 32));
    return (uint64_t)w + gl::times_eps((uint64_t)(w >> 64));
  }
};

// Full round r (0..7 of the table): constants, the s-box on every element,
// the circulant.
__device__ __forceinline__ void full_round(uint64_t* s, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i)
    s[i] = sbox7(gl::add_canon_lazy(s[i], c_tree[r * WIDTH + i]));
  mds_regs(s);
}

// s[1..12) = A_0 s[1..12), once before the partial rounds.
__device__ __forceinline__ void dense_a0(uint64_t* s) {
  uint64_t out[WIDTH - 1];
#pragma unroll
  for (int i = 0; i < WIDTH - 1; ++i) {
    Acc a = {0, 0, 0};
#pragma unroll
    for (int j = 0; j < WIDTH - 1; ++j)
      a.mac(s[1 + j], c_tree[FULL_SIZE + i * (WIDTH - 1) + j]);
    out[i] = a.reduce();
  }
#pragma unroll
  for (int i = 0; i < WIDTH - 1; ++i) s[1 + i] = out[i];
}

// Sparse partial round r: y = sbox(s0 + k), s0 = y + sum_i w[i] s_i,
// s_i = s_i + v[i] y (i = 1..11), each s_i a 128-bit product plus a u64
// (< 2^128) reduced once.
__device__ __forceinline__ void partial_round(uint64_t* s, int r) {
  const int at = PARTIAL_AT + r * PARTIAL_STRIDE;  // k, then w, then v
  const uint64_t y = sbox7(gl::add_canon_lazy(s[0], c_tree[at]));
  Acc a = {y, 0, 0};
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) a.mac(s[i], c_tree[at + i]);
#pragma unroll
  for (int i = 1; i < WIDTH; ++i)
    s[i] = gl::reduce128_lazy((gl::u128)y * c_tree[at + WIDTH - 1 + i] + s[i]);
  s[0] = a.reduce();
}

// One permutation on a thread's registers, lazy in and out.
__device__ __forceinline__ void permute_regs(uint64_t* s) {
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
  dense_a0(s);
#pragma unroll 1
  for (int r = 0; r < PARTIAL; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = HALF_FULL; r < 2 * HALF_FULL; ++r) full_round(s, r);
}

// cols: k rows of m leaf elements, row r at cols + r * ld; out: (4, m).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
leaf_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
            int k, long long m, long long ld) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= m) return;
  uint64_t s[WIDTH] = {};
  for (int r0 = 0; r0 < k; r0 += RATE) {
    const uint64_t* src = cols + (long long)r0 * ld + t;
#pragma unroll
    for (int i = 0; i < RATE; ++i) s[i] = r0 + i < k ? src[i * ld] : 0;
    permute_regs(s);
  }
#pragma unroll
  for (int i = 0; i < CAP; ++i) out[i * m + t] = gl::canonicalize(s[i]);
}

// cur: (4, 2 * half) nodes, 16-byte aligned; out: (4, half) parents.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
node_kernel(const uint64_t* __restrict__ cur, uint64_t* __restrict__ out,
            long long half) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= half) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const ulonglong2 pair =
        reinterpret_cast<const ulonglong2*>(cur + 2 * half * i)[t];
    s[i] = pair.x;        // left sibling
    s[CAP + i] = pair.y;  // right sibling
  }
#pragma unroll
  for (int i = RATE; i < WIDTH; ++i) s[i] = 0;
  permute_regs(s);
#pragma unroll
  for (int i = 0; i < CAP; ++i) out[i * half + t] = gl::canonicalize(s[i]);
}

// byte_tree's node hash: the digest is 4 elements, the state left ‖ right ‖ 0.
struct TreeNodeHash {
  static constexpr int WORDS = CAP;
  using Word = uint64_t;
  __device__ __forceinline__ void operator()(const uint64_t in[2 * CAP],
                                             uint64_t h[CAP]) const {
    uint64_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < RATE; ++i) s[i] = in[i];
#pragma unroll
    for (int i = RATE; i < WIDTH; ++i) s[i] = 0;
    permute_regs(s);
#pragma unroll
    for (int i = 0; i < CAP; ++i) h[i] = gl::canonicalize(s[i]);
  }
};

__global__ void __launch_bounds__(byte_tree::THREADS, NODE_MIN_BLOCKS)
nodes_kernel(const uint64_t* cur, uint64_t* out, long long m, int levels,
             unsigned* tickets) {
  byte_tree::node_tree(cur, out, m, levels, tickets, TreeNodeHash());
}

unsigned grid_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// state, out: (12,); elems: (k,), k >= 0; rc: the ROUNDS x 12 round
// constants, round-major. out may not alias.
extern "C" int poseidon_absorb(const void* state, const void* elems,
                               long long k, void* out, const void* rc,
                               void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  absorb_kernel<<<1, WIDTH, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)state, (const uint64_t*)elems, k, (uint64_t*)out,
      (const uint64_t*)rc);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_permute(const void* state, void* out, const void* rc,
                                void* stream) {
  permute_kernel<<<1, WIDTH, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)state, (uint64_t*)out, (const uint64_t*)rc);
  return (int)cudaGetLastError();
}

// Copies poseidon_sparse.py's table (TABLE_SIZE canonical u64) into constant
// memory after checking its size and the host's 12 MDS exponents against
// the compiled ones; call once per device before the first tree launch.
extern "C" int poseidon_tree_set_constants(const void* table, long long n,
                                           const void* exps) {
  const long long* e = (const long long*)exps;
  if (n != TABLE_SIZE) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < WIDTH; ++j)
    if (e[j] != mds_exp(j)) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_tree, table, sizeof(uint64_t) * n);
}

// cols: k >= 1 rows of m elements at a row stride of ld >= m; out: (4, m).
extern "C" int poseidon_leaf_hashes(const void* cols, void* out, int k,
                                    long long m, long long ld, void* stream) {
  if (k < 1 || m <= 0 || ld < m) return (int)cudaErrorInvalidValue;
  leaf_kernel<<<grid_for(m), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cols, (uint64_t*)out, k, m, ld);
  return (int)cudaGetLastError();
}

// cur: (4, m), m even, 16-byte aligned; out: (4, m / 2).
extern "C" int poseidon_node_layer(const void* cur, void* out, long long m,
                                   void* stream) {
  if (m <= 0 || m % 2 || (uintptr_t)cur % 16) return (int)cudaErrorInvalidValue;
  node_kernel<<<grid_for(m / 2), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cur, (uint64_t*)out, m / 2);
  return (int)cudaGetLastError();
}

// cur: (4, m), m a multiple of 2^levels, 16-byte aligned; out receives the
// `levels` layers above it one after the other, (4, m / 2), (4, m / 4), ...;
// tickets: byte_tree's zeroed hand-on counters.
extern "C" int poseidon_node_layers(const void* cur, void* out, long long m,
                                    int levels, void* tickets, void* stream) {
  if (!byte_tree::valid(m, levels) || (uintptr_t)cur % 16)
    return (int)cudaErrorInvalidValue;
  nodes_kernel<<<byte_tree::grid(m), byte_tree::THREADS, 0,
                 (cudaStream_t)stream>>>((const uint64_t*)cur, (uint64_t*)out,
                                         m, levels, (unsigned*)tickets);
  return (int)cudaGetLastError();
}
