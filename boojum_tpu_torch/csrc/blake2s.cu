// Blake2s-256 leaf and node hashes of the byte Merkle trees, kernel K8.
//
// Replaces boojum_tpu/hash/device_bytes_hash.py blake2s_leaves_traced (a
// lax.scan over the 64-byte message blocks around a 10-round fori_loop) and
// blake2s_nodes_traced. No TPU kernel stands behind them (XLA compiles each
// into one loop), but in eager torch one compression would be about 1,100
// launches, so the hash gets a kernel of its own.
//
// Entries (plain C, one launch each, on the caller's stream):
// - blake2s_leaf_hashes(cols, out, k, m, ld): cols holds k rows of m
//   canonical u64 elements, row j at cols + j * ld; leaf i is column i, its
//   bytes the k elements little-endian. out is (8, m): word w of digest i
//   at out[w * m + i], as a u64 in [0, 2^32).
// - blake2s_node_layers(cur, out, m, levels, tickets): cur is an (8, m)
//   digest layer, m a multiple of 2^levels; out receives the `levels`
//   layers above it one after the other ((8, m / 2), then (8, m / 4), ...),
//   each digest the hash of left || right of its sibling pair; tickets
//   holds byte_tree's zeroed hand-on counters (byte_tree.cuh: one launch a
//   tree, blocks of 3 levels handing on to the last of each 8).
//
// Bound: the operations. A compression is 10 rounds of 8 G functions, each
// 6 adds, 4 xors and 4 rotates on 32-bit words, all dependent within a G
// but four G's independent within a half-round; the leaf reads 8k bytes
// and writes 32. At the flagship's widest leaf (93 elements, 12 blocks)
// that is 1,120 integer operations per 62 bytes read.
//
// Design: one thread per leaf or parent, the chaining value, the 16 working
// words and the message block in registers. The 10 rounds are written out
// with their message schedule as literals (BLAKE2S_ROUND), so every message
// index is a register name, not a memory lookup. Threads of a warp read 32
// neighbouring columns of the same row: the loads coalesce. The counter t
// is the byte count so far (at most 8k); the final block, zero-padded past
// k elements, carries the last-block flag.
#include <cstdint>
#include <cuda_runtime.h>

#include "byte_tree.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t ror(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

#define G(a, b, c, d, x, y)      \
  a = a + b + (x);               \
  d = ror(d ^ a, 16);            \
  c = c + d;                     \
  b = ror(b ^ c, 12);            \
  a = a + b + (y);               \
  d = ror(d ^ a, 8);             \
  c = c + d;                     \
  b = ror(b ^ c, 7);

#define BLAKE2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11,  \
                      s12, s13, s14, s15)                                \
  G(v0, v4, v8, v12, m[s0], m[s1])                                       \
  G(v1, v5, v9, v13, m[s2], m[s3])                                       \
  G(v2, v6, v10, v14, m[s4], m[s5])                                      \
  G(v3, v7, v11, v15, m[s6], m[s7])                                      \
  G(v0, v5, v10, v15, m[s8], m[s9])                                      \
  G(v1, v6, v11, v12, m[s10], m[s11])                                    \
  G(v2, v7, v8, v13, m[s12], m[s13])                                     \
  G(v3, v4, v9, v14, m[s14], m[s15])

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint32_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint32_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = 0x6A09E667u, v9 = 0xBB67AE85u, v10 = 0x3C6EF372u,
           v11 = 0xA54FF53Au;
  uint32_t v12 = 0x510E527Fu ^ t, v13 = 0x9B05688Cu;
  uint32_t v14 = last ? ~0x1F83D9ABu : 0x1F83D9ABu, v15 = 0x5BE0CD19u;
  BLAKE2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  BLAKE2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  BLAKE2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  BLAKE2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  BLAKE2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  BLAKE2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  BLAKE2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  BLAKE2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  BLAKE2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  BLAKE2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

__device__ __forceinline__ void init(uint32_t h[8]) {
  h[0] = 0x6A09E667u ^ 0x01010020u;  // digest length 32, fanout 1, depth 1
  h[1] = 0xBB67AE85u;
  h[2] = 0x3C6EF372u;
  h[3] = 0xA54FF53Au;
  h[4] = 0x510E527Fu;
  h[5] = 0x9B05688Cu;
  h[6] = 0x1F83D9ABu;
  h[7] = 0x5BE0CD19u;
}

__global__ void __launch_bounds__(THREADS)
    leaf_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
                int k, long long m, long long ld) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  uint32_t h[8];
  init(h);
  const int nb = (k + 7) / 8;
  const uint32_t total = 8u * (uint32_t)k;
  for (int b = 0; b < nb; ++b) {
    uint32_t m16[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = 8 * b + j;
      const uint64_t x = e < k ? cols[(long long)e * ld + i] : 0ull;
      m16[2 * j] = (uint32_t)x;
      m16[2 * j + 1] = (uint32_t)(x >> 32);
    }
    compress(h, m16, min(64u * (uint32_t)(b + 1), total), b == nb - 1);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * m + i] = h[w];
}

// the node hash: one compression of the 64 bytes left || right, counter 64,
// last-block flag set
struct NodeHash {
  static constexpr int WORDS = 8;  // u32 words a digest
  using Word = uint32_t;
  __device__ __forceinline__ void operator()(const uint32_t in[16],
                                             uint32_t h[8]) const {
    init(h);
    compress(h, in, 64u, true);
  }
};

__global__ void __launch_bounds__(byte_tree::THREADS)
    nodes_kernel(const uint64_t* cur, uint64_t* out, long long m, int levels,
                 unsigned* tickets) {
  byte_tree::node_tree(cur, out, m, levels, tickets, NodeHash());
}

unsigned grid_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int blake2s_leaf_hashes(const void* cols, void* out, int k,
                                   long long m, long long ld, void* stream) {
  if (k < 1 || m < 1) return (int)cudaErrorInvalidValue;
  leaf_kernel<<<grid_for(m), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cols, (uint64_t*)out, k, m, ld);
  return (int)cudaGetLastError();
}

extern "C" int blake2s_node_layers(const void* cur, void* out, long long m,
                                   int levels, void* tickets, void* stream) {
  if (!byte_tree::valid(m, levels)) return (int)cudaErrorInvalidValue;
  nodes_kernel<<<byte_tree::grid(m), byte_tree::THREADS, 0,
                 (cudaStream_t)stream>>>((const uint64_t*)cur, (uint64_t*)out,
                                         m, levels, (unsigned*)tickets);
  return (int)cudaGetLastError();
}
