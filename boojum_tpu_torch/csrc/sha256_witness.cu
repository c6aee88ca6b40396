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
// other; each costs its critical path (the e -> s1 -> tmp1 -> te -> e chain,
// about a dozen dependent integer operations) times their latency. The
// bytes (8 * 20 * 64 * nb written) and operations are tiny beside it.
//
// Design: one block of 256 threads. Phase 1 computes the schedules, one
// message block per thread (the schedule of a block does not depend on the
// chain), and writes W, the schedule sums and the zero columns. After a
// barrier, thread 0 walks the chain with the state in registers, reading W
// back from global memory (L1/L2) and storing each round's values.
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

__device__ __forceinline__ uint32_t ror(uint32_t v, int r) {
  return __funnelshift_r(v, v, r);
}

__global__ void __launch_bounds__(THREADS)
sha256_witness_kernel(const long long* __restrict__ blocks,
                      const long long* __restrict__ init,
                      long long* __restrict__ out, long long nb) {
  const long long plane = nb * 64;  // elements of one output row
  auto at = [&](int row, long long b, int i) -> long long* {
    return out + row * plane + b * 64 + i;
  };

  // phase 1: schedules, one message block per thread
  for (long long b = threadIdx.x; b < nb; b += blockDim.x) {
    uint32_t w[64];
    const long long* m = blocks + b * 64;
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
      *at(R_SCH_LO, b, i - 16) = (uint32_t)t;
      *at(R_SCH_HI, b, i - 16) = (long long)(t >> 32);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) *at(R_W, b, i) = w[i];
    for (int i = 48; i < 64; ++i) {
      *at(R_SCH_LO, b, i) = 0;
      *at(R_SCH_HI, b, i) = 0;
    }
    for (int i = 8; i < 64; ++i) {
      *at(R_STATE_IN, b, i) = 0;
      *at(R_FIN_LO, b, i) = 0;
      *at(R_FIN_HI, b, i) = 0;
    }
  }
  __syncthreads();  // W of every block is now visible to thread 0
  if (threadIdx.x != 0) return;

  // phase 2: the chain, sequential over blocks and rounds
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = (uint32_t)init[i];
  for (long long b = 0; b < nb; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) *at(R_STATE_IN, b, i) = st[i];
    uint32_t a = st[0], bb = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
    const long long* wb = at(R_W, b, 0);
    for (int r = 0; r < 64; ++r) {
      const uint32_t wr = (uint32_t)wb[r];
      const uint32_t s1 = ror(e, 6) ^ ror(e, 11) ^ ror(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint64_t tmp1 = (uint64_t)h + s1 + ch + K[r];
      const uint64_t tmp1w = tmp1 + wr;
      const uint64_t te = tmp1w + d;
      const uint32_t s0 = ror(a, 2) ^ ror(a, 13) ^ ror(a, 22);
      const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      const uint64_t ta = (uint64_t)s0 + maj + tmp1w;
      *at(R_S1, b, r) = s1;
      *at(R_CH, b, r) = ch;
      *at(R_S0, b, r) = s0;
      *at(R_MAJ, b, r) = maj;
      *at(R_TMP1_LO, b, r) = (uint32_t)tmp1;
      *at(R_TMP1_HI, b, r) = (long long)(tmp1 >> 32);
      *at(R_TMP1W_LO, b, r) = (uint32_t)tmp1w;
      *at(R_TMP1W_HI, b, r) = (long long)(tmp1w >> 32);
      *at(R_TE_LO, b, r) = (uint32_t)te;
      *at(R_TE_HI, b, r) = (long long)(te >> 32);
      *at(R_TA_LO, b, r) = (uint32_t)ta;
      *at(R_TA_HI, b, r) = (long long)(ta >> 32);
      *at(R_NEW_E, b, r) = (uint32_t)te;
      *at(R_NEW_A, b, r) = (uint32_t)ta;
      h = g; g = f; f = e; e = (uint32_t)te;
      d = c; c = bb; bb = a; a = (uint32_t)ta;
    }
    const uint32_t fin[8] = {a, bb, c, d, e, f, g, h};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint64_t ft = (uint64_t)st[i] + fin[i];
      *at(R_FIN_LO, b, i) = (uint32_t)ft;
      *at(R_FIN_HI, b, i) = (long long)(ft >> 32);
      st[i] = (uint32_t)ft;
    }
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
