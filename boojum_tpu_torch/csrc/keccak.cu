// Keccak-256 leaf and node hashes of the byte Merkle trees, kernel K9.
//
// Replaces boojum_tpu/hash/device_bytes_hash.py keccak_leaves_traced (the
// absorb lax.scan around a 24-round fori_loop of Keccak-f[1600] on (lo, hi)
// 32-bit limb pairs) and keccak_nodes_traced. No TPU kernel stands behind
// them (XLA compiles each into one loop); in eager torch one permutation
// would be about 2,000 launches, so the hash gets a kernel of its own.
// Keccak-256 here is the legacy (Ethereum) one: pad 0x01 ... 0x80, not
// SHA3's 0x06.
//
// Entries (plain C, one launch each, on the caller's stream):
// - keccak_leaf_hashes(cols, out, k, m, ld): cols holds k rows of m
//   canonical u64 elements, row j at cols + j * ld; leaf i is column i, its
//   bytes the k elements little-endian, so element j is message lane j.
//   out is (8, m): word w of digest i at out[w * m + i], a u64 in
//   [0, 2^32).
// - keccak_node_layers(cur, out, m, levels, tickets): cur is an (8, m)
//   digest layer, m a multiple of 2^levels; out receives the `levels`
//   layers above it one after the other ((8, m / 2), then (8, m / 4), ...),
//   each digest the hash of the 64 bytes left || right of its sibling pair;
//   tickets holds byte_tree's zeroed hand-on counters (byte_tree.cuh: one
//   launch a tree, blocks of 3 levels handing on to the last of each 8).
//
// Bound: the operations. A permutation is 24 rounds of theta (50 xors, 5
// rotates), rho and pi (25 rotates), chi (25 and-nots, 25 xors) and iota on
// 64-bit lanes, each a pair of 32-bit instructions on the SM; a 136-byte
// block absorbs with one permutation. The flagship's widest leaf (93
// elements) is 6 permutations per 744 bytes read.
//
// Design: one thread per leaf or parent with the 25 lanes in registers. The
// round is written out lane by lane (rotation counts as template
// arguments), and only the round constant is read from constant memory, so
// the round loop stays rolled and small. A 17-lane block is read row by
// row, neighbouring threads on neighbouring columns, so the loads coalesce.
// The pad goes in as the block is absorbed: lane k gets 0x01 and lane 16 of
// the final block bit 63; when k is a multiple of 17 the pad takes a block
// of its own.
#include <cstdint>
#include <cuda_runtime.h>

#include "byte_tree.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int RATE = 17;  // lanes of the 136-byte rate

__constant__ uint64_t RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

template <int R>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  if constexpr (R == 0) {
    return x;
  } else {
    return (x << R) | (x >> (64 - R));
  }
}

// Keccak-f[1600] on lanes s[x + 5 y] (the reference's lanes[x][y]).
__device__ __forceinline__ void keccak_f(uint64_t s[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    const uint64_t c0 = s[0] ^ s[5] ^ s[10] ^ s[15] ^ s[20];
    const uint64_t c1 = s[1] ^ s[6] ^ s[11] ^ s[16] ^ s[21];
    const uint64_t c2 = s[2] ^ s[7] ^ s[12] ^ s[17] ^ s[22];
    const uint64_t c3 = s[3] ^ s[8] ^ s[13] ^ s[18] ^ s[23];
    const uint64_t c4 = s[4] ^ s[9] ^ s[14] ^ s[19] ^ s[24];
    const uint64_t d0 = c4 ^ rotl<1>(c1);
    const uint64_t d1 = c0 ^ rotl<1>(c2);
    const uint64_t d2 = c1 ^ rotl<1>(c3);
    const uint64_t d3 = c2 ^ rotl<1>(c4);
    const uint64_t d4 = c3 ^ rotl<1>(c0);
    const uint64_t b0 = rotl<0>(s[0] ^ d0);
    const uint64_t b1 = rotl<44>(s[6] ^ d1);
    const uint64_t b2 = rotl<43>(s[12] ^ d2);
    const uint64_t b3 = rotl<21>(s[18] ^ d3);
    const uint64_t b4 = rotl<14>(s[24] ^ d4);
    const uint64_t b5 = rotl<28>(s[3] ^ d3);
    const uint64_t b6 = rotl<20>(s[9] ^ d4);
    const uint64_t b7 = rotl<3>(s[10] ^ d0);
    const uint64_t b8 = rotl<45>(s[16] ^ d1);
    const uint64_t b9 = rotl<61>(s[22] ^ d2);
    const uint64_t b10 = rotl<1>(s[1] ^ d1);
    const uint64_t b11 = rotl<6>(s[7] ^ d2);
    const uint64_t b12 = rotl<25>(s[13] ^ d3);
    const uint64_t b13 = rotl<8>(s[19] ^ d4);
    const uint64_t b14 = rotl<18>(s[20] ^ d0);
    const uint64_t b15 = rotl<27>(s[4] ^ d4);
    const uint64_t b16 = rotl<36>(s[5] ^ d0);
    const uint64_t b17 = rotl<10>(s[11] ^ d1);
    const uint64_t b18 = rotl<15>(s[17] ^ d2);
    const uint64_t b19 = rotl<56>(s[23] ^ d3);
    const uint64_t b20 = rotl<62>(s[2] ^ d2);
    const uint64_t b21 = rotl<55>(s[8] ^ d3);
    const uint64_t b22 = rotl<39>(s[14] ^ d4);
    const uint64_t b23 = rotl<41>(s[15] ^ d0);
    const uint64_t b24 = rotl<2>(s[21] ^ d1);
    s[0] = b0 ^ (~b1 & b2);
    s[1] = b1 ^ (~b2 & b3);
    s[2] = b2 ^ (~b3 & b4);
    s[3] = b3 ^ (~b4 & b0);
    s[4] = b4 ^ (~b0 & b1);
    s[5] = b5 ^ (~b6 & b7);
    s[6] = b6 ^ (~b7 & b8);
    s[7] = b7 ^ (~b8 & b9);
    s[8] = b8 ^ (~b9 & b5);
    s[9] = b9 ^ (~b5 & b6);
    s[10] = b10 ^ (~b11 & b12);
    s[11] = b11 ^ (~b12 & b13);
    s[12] = b12 ^ (~b13 & b14);
    s[13] = b13 ^ (~b14 & b10);
    s[14] = b14 ^ (~b10 & b11);
    s[15] = b15 ^ (~b16 & b17);
    s[16] = b16 ^ (~b17 & b18);
    s[17] = b17 ^ (~b18 & b19);
    s[18] = b18 ^ (~b19 & b15);
    s[19] = b19 ^ (~b15 & b16);
    s[20] = b20 ^ (~b21 & b22);
    s[21] = b21 ^ (~b22 & b23);
    s[22] = b22 ^ (~b23 & b24);
    s[23] = b23 ^ (~b24 & b20);
    s[24] = b24 ^ (~b20 & b21);
    s[0] ^= RC[r];
  }
}

__device__ __forceinline__ void write_digest(const uint64_t s[25],
                                             uint64_t* out, long long stride,
                                             long long i) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    out[(2 * w) * stride + i] = s[w] & 0xFFFFFFFFull;
    out[(2 * w + 1) * stride + i] = s[w] >> 32;
  }
}

__global__ void __launch_bounds__(THREADS)
    leaf_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
                int k, long long m, long long ld) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  uint64_t s[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) s[j] = 0;
  const int nb = k / RATE + 1;  // the pad takes at least one byte
  for (int b = 0; b < nb; ++b) {
#pragma unroll
    for (int j = 0; j < RATE; ++j) {
      const int e = RATE * b + j;
      uint64_t x = e < k ? cols[(long long)e * ld + i] : 0ull;
      if (e == k) x ^= 0x01ull;
      if (j == RATE - 1 && b == nb - 1) x ^= 0x8000000000000000ull;
      s[j] ^= x;
    }
    keccak_f(s);
  }
  write_digest(s, out, m, i);
}

// the node hash: the 64 bytes left || right as lanes 0-7, the pad's 0x01
// in lane 8 and its 0x80 in lane 16, one permutation
struct NodeHash {
  static constexpr int WORDS = 8;  // u32 words a digest
  using Word = uint32_t;
  __device__ __forceinline__ void operator()(const uint32_t in[16],
                                             uint32_t h[8]) const {
    uint64_t s[25];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[j] = (uint64_t)in[2 * j] | ((uint64_t)in[2 * j + 1] << 32);
    s[8] = 0x01ull;
#pragma unroll
    for (int j = 9; j < 25; ++j) s[j] = 0;
    s[RATE - 1] = 0x8000000000000000ull;
    keccak_f(s);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      h[2 * w] = (uint32_t)s[w];
      h[2 * w + 1] = (uint32_t)(s[w] >> 32);
    }
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

extern "C" int keccak_leaf_hashes(const void* cols, void* out, int k,
                                  long long m, long long ld, void* stream) {
  if (k < 1 || m < 1) return (int)cudaErrorInvalidValue;
  leaf_kernel<<<grid_for(m), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cols, (uint64_t*)out, k, m, ld);
  return (int)cudaGetLastError();
}

extern "C" int keccak_node_layers(const void* cur, void* out, long long m,
                                  int levels, void* tickets, void* stream) {
  if (!byte_tree::valid(m, levels)) return (int)cudaErrorInvalidValue;
  nodes_kernel<<<byte_tree::grid(m), byte_tree::THREADS, 0,
                 (cudaStream_t)stream>>>((const uint64_t*)cur, (uint64_t*)out,
                                         m, levels, (unsigned*)tickets);
  return (int)cudaGetLastError();
}
