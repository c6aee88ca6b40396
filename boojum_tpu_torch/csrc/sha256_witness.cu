// SHA-256 compression chain of the device witness: for nb message blocks
// chained from an initial state, the message schedule and every value of
// the 64 rounds of each block that the SHA-256 circuit's witness holds.
//
// Replaces the two lax.scans of boojum_tpu/gadgets/sha256.py
// _sha256_witness_dev (the schedule loop and the round_body / block_body
// scans). No TPU kernel stands behind them (XLA compiles each scan into one
// loop), but in eager torch the flagship's 129 blocks x 64 rounds would be
// about 370,000 launches, so the chain gets a kernel of its own.
//
// Output: one (ROWS, nb, 64) int64 array, rows as in
// boojum_tpu_torch/gadgets/sha256_witness.py ROW: W; the 48 schedule sums
// t = s0 + s1 + W[i-7] + W[i-16] as lo / hi; per round s1, ch, s0, maj,
// tmp1, tmp1w, te, ta (the wide ones as lo = sum mod 2^32, hi = sum >> 32,
// the exact carries of the JAX add_pairs / pair_add), new_e, new_a; per
// block the 8 words of the state it starts from, and the final additions
// state_in + state_after_64_rounds as lo / hi. Unused columns are zero.
//
// Bound: the dependency chain. Rounds are sequential within a block and
// blocks through the chaining state, so nb * 64 rounds run one after the
// other. Only new_e and new_a carry the chain, in 32-bit arithmetic:
// new_e = d + h + s1(e) + ch(e, f, g) + K[r] + W[r] and
// new_a = that sum - d + s0(a) + maj(a, b, c), where d and h are values of
// four rounds back, so a round's critical path is about 4 dependent
// integer instructions (rotates, one three-input xor, one three-input add).
// The bytes (8 * 20 * 64 * nb written) and the operations are tiny beside it.
//
// Design: record the chain, expand in parallel. Every value of round r
// follows from the state before it and W[r], and that state is the last
// four new_a (a, b, c, d) and the last four new_e (e, f, g, h). One block
// of THREADS threads walks the message blocks in chunks of CHUNK:
// 1. one thread a message block computes its schedule into shared memory;
// 2. thread 0 runs the chain over the chunk with the state in registers,
//    its 64 rounds unrolled (K[r] an immediate), and records only new_e and
//    new_a in shared memory (two shared stores a round, no device store);
// 3. every thread expands (message block, round) pairs: the state before
//    the round from the recorded history (the chunk's start states for the
//    first four rounds), then all 20 output rows with their exact 64-bit
//    sums, stored along the round index so that a warp's stores coalesce.
// The other threads idle while thread 0 walks the chain; the expansion
// and the schedules of a chunk cost a few microseconds beside it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 20;
enum Row {
  R_W, R_SCH_LO, R_SCH_HI, R_S1, R_CH, R_S0, R_MAJ, R_TMP1_LO, R_TMP1_HI,
  R_TMP1W_LO, R_TMP1W_HI, R_TE_LO, R_TE_HI, R_TA_LO, R_TA_HI, R_NEW_E,
  R_NEW_A, R_STATE_IN, R_FIN_LO, R_FIN_HI
};
static_assert(R_FIN_HI + 1 == ROWS, "row count");

__constant__ uint32_t K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

constexpr int THREADS = 256;
constexpr int CHUNK = 32;  // message blocks per pass through the phases

__device__ __forceinline__ uint32_t ror(uint32_t v, int r) {
  return __funnelshift_r(v, v, r);
}

__device__ __forceinline__ uint32_t big_s1(uint32_t e) {
  return ror(e, 6) ^ ror(e, 11) ^ ror(e, 25);
}

__device__ __forceinline__ uint32_t big_s0(uint32_t a) {
  return ror(a, 2) ^ ror(a, 13) ^ ror(a, 22);
}

__device__ __forceinline__ uint32_t choose(uint32_t e, uint32_t f,
                                           uint32_t g) {
  return (e & f) ^ (~e & g);
}

__device__ __forceinline__ uint32_t majority(uint32_t a, uint32_t b,
                                             uint32_t c) {
  return (a & b) ^ (a & c) ^ (b & c);
}

struct Shared {
  uint32_t w[CHUNK][64];      // the schedule W
  uint64_t sch[CHUNK][48];    // the schedule sums t (< 2^34)
  uint32_t new_a[CHUNK][64];  // the chain's record
  uint32_t new_e[CHUNK][64];
  uint32_t start[CHUNK][8];   // each block's starting state
  uint32_t k[64];             // K, for lanes that read different rounds
};

__global__ void __launch_bounds__(THREADS)
sha256_witness_kernel(const long long* __restrict__ blocks,
                      const long long* __restrict__ init,
                      long long* __restrict__ out, long long nb) {
  __shared__ Shared sh;
  const long long plane = nb * 64;  // elements of one output row
  const int tid = threadIdx.x;
  if (tid < 64) sh.k[tid] = K[tid];
  uint32_t st[8];  // the chaining state (thread 0)
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = (uint32_t)init[i];

  for (long long b0 = 0; b0 < nb; b0 += CHUNK) {
    const int cnt = (int)(nb - b0 < CHUNK ? nb - b0 : CHUNK);

    // 1. schedules, one message block a thread
    if (tid < cnt) {
      uint32_t w[64];
      const long long* m = blocks + (b0 + tid) * 64;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = ((uint32_t)m[4 * i] << 24) | ((uint32_t)m[4 * i + 1] << 16) |
               ((uint32_t)m[4 * i + 2] << 8) | (uint32_t)m[4 * i + 3];
#pragma unroll
      for (int i = 16; i < 64; ++i) {
        const uint32_t x0 = w[i - 15], x1 = w[i - 2];
        const uint32_t s0 = ror(x0, 7) ^ ror(x0, 18) ^ (x0 >> 3);
        const uint32_t s1 = ror(x1, 17) ^ ror(x1, 19) ^ (x1 >> 10);
        const uint64_t t = (uint64_t)s0 + s1 + w[i - 7] + w[i - 16];
        w[i] = (uint32_t)t;
        sh.sch[tid][i - 16] = t;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sh.w[tid][i] = w[i];
    }
    __syncthreads();

    // 2. the chain: new_e and new_a of every round, in 32 bits
    if (tid == 0) {
      for (int t = 0; t < cnt; ++t) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sh.start[t][i] = st[i];
        uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
        uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          // h, d and W are known rounds ahead: the sums wait only for
          // s1 and ch of e (and s0, maj of a), one three-input add each
          const uint32_t x = h + K[r] + sh.w[t][r];
          const uint32_t s1 = big_s1(e), ch = choose(e, f, g);
          const uint32_t ne = (x + d) + s1 + ch;
          const uint32_t na = (x + big_s0(a) + majority(a, b, c)) + s1 + ch;
          sh.new_e[t][r] = ne;
          sh.new_a[t][r] = na;
          h = g; g = f; f = e; e = ne;
          d = c; c = b; b = a; a = na;
        }
        st[0] += a; st[1] += b; st[2] += c; st[3] += d;
        st[4] += e; st[5] += f; st[6] += g; st[7] += h;
      }
    }
    __syncthreads();

    // 3. expansion: one (message block, round) pair a thread per step
    for (int p = tid; p < cnt * 64; p += THREADS) {
      const int t = p >> 6, r = p & 63;
      // A(i) = new_a of round i, E(i) = new_e; before round 0 the start
      // state: A(-1 .. -4) = a, b, c, d and E(-1 .. -4) = e, f, g, h
      auto A = [&](int i) { return i >= 0 ? sh.new_a[t][i] : sh.start[t][-i - 1]; };
      auto E = [&](int i) { return i >= 0 ? sh.new_e[t][i] : sh.start[t][3 - i]; };
      const uint32_t a = A(r - 1), b = A(r - 2), c = A(r - 3), d = A(r - 4);
      const uint32_t e = E(r - 1), f = E(r - 2), g = E(r - 3), h = E(r - 4);
      const uint32_t w = sh.w[t][r];
      const uint32_t s1 = big_s1(e), ch = choose(e, f, g);
      const uint32_t s0 = big_s0(a), maj = majority(a, b, c);
      const uint64_t tmp1 = (uint64_t)h + s1 + ch + sh.k[r];
      const uint64_t tmp1w = tmp1 + w;
      const uint64_t te = tmp1w + d;
      const uint64_t ta = (uint64_t)s0 + maj + tmp1w;
      uint64_t sch = 0, fin = 0;
      uint32_t start = 0;
      if (r < 48) sch = sh.sch[t][r];
      if (r < 8) {
        start = sh.start[t][r];
        fin = (uint64_t)start + (r < 4 ? A(63 - r) : E(67 - r));
      }
      long long* o = out + (b0 + t) * 64 + r;
      auto put = [&](int row, uint64_t v) { o[row * plane] = (long long)v; };
      put(R_W, w);
      put(R_SCH_LO, (uint32_t)sch);
      put(R_SCH_HI, sch >> 32);
      put(R_S1, s1);
      put(R_CH, ch);
      put(R_S0, s0);
      put(R_MAJ, maj);
      put(R_TMP1_LO, (uint32_t)tmp1);
      put(R_TMP1_HI, tmp1 >> 32);
      put(R_TMP1W_LO, (uint32_t)tmp1w);
      put(R_TMP1W_HI, tmp1w >> 32);
      put(R_TE_LO, (uint32_t)te);
      put(R_TE_HI, te >> 32);
      put(R_TA_LO, (uint32_t)ta);
      put(R_TA_HI, ta >> 32);
      put(R_NEW_E, (uint32_t)te);
      put(R_NEW_A, (uint32_t)ta);
      put(R_STATE_IN, start);
      put(R_FIN_LO, (uint32_t)fin);
      put(R_FIN_HI, fin >> 32);
    }
    __syncthreads();  // the next chunk reuses the shared arrays
  }
}

}  // namespace

// blocks: (nb, 64) int64 message bytes; init: (8,) int64 state words;
// out: (20, nb, 64) int64. No argument may alias another.
extern "C" int sha256_witness(const void* blocks, const void* init, void* out,
                              long long nb, void* stream) {
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  sha256_witness_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)blocks, (const long long*)init, (long long*)out, nb);
  return (int)cudaGetLastError();
}
