// The node layers of a Merkle tree, all in one launch: the schedule that
// the byte trees' kernels K8 (blake2s.cu) and K9 (keccak.cu) and the
// classic-Poseidon tree (poseidon.cu) share around their own node hash.
//
// The schedule is generic over the digest, which the node hash declares:
// Hash::WORDS planes of Hash::Word (K8 / K9: 8 u32 words; Poseidon: 4
// Goldilocks elements, u64). A layer holds m digests as WORDS planes: word
// w of digest i at layer[w * m + i], a u64 (a u32 word's value in [0,
// 2^32)). One launch of a kernel around node_tree, over grid(m) blocks of
// THREADS threads, computes the `levels` layers above a (WORDS, m) layer
// `cur` (m a multiple of 2^levels) and writes them one after the other from
// `out`: (WORDS, m / 2), then (WORDS, m / 4), ...
//
// Stages. The levels go in stages of STAGE levels (the last stage may have
// fewer). A block of stage s owns the subtree over n = min(2 THREADS,
// width - first) digests of the stage's input layer (width digests) from
// first = 2 THREADS b; n is a multiple of 2^(the stage's levels), as the
// width and 2 THREADS are, so every level pairs whole siblings.
// - Its first level: thread t < n / 2 reads siblings first + 2t and
//   first + 2t + 1 from device memory (one 16-byte load a word plane, past
//   the L1 cache: another block may have written them in this launch),
//   hashes them, keeps the parent in shared slot t and writes it to its
//   layer at first / 2 + t.
// - Its level j >= 1: thread t < n >> (j + 1) reads slots 2t and 2t + 1;
//   after a barrier, so that no slot is overwritten before it is read, it
//   hashes them into slot t and writes the parent to its layer at
//   (first >> (j + 1)) + t. A second barrier publishes the level.
// With THREADS = 256 and STAGE = 3 a full stage's levels have 256, 128 and
// 64 parents: every warp that hashes has all its lanes busy.
//
// Handing on. A full stage leaves 2 THREADS >> STAGE = 64 digests a block,
// so GROUP = 2^STAGE = 8 blocks of stage s hold the 2 THREADS inputs of one
// block of stage s + 1. Each block, once its digests are written, fences them
// (__threadfence) and takes a ticket from its group's counter (atomicAdd);
// the block that draws the group's last ticket goes on as block b / GROUP
// of stage s + 1, the others exit. The counters (one a group of every
// stage but the last, stage after stage) start at zero; `tickets` gives
// their number. No block waits on another, so no order of the blocks
// can stall the launch.
//
// A launch may also cover only part of a tree: the wrapper gives a tree of
// more than 2^17 digests two launches, its first stage alone and then the
// rest (measured faster there for K8 and K9;
// device_bytes_hash.node_launches, which the Poseidon tree shares).
//
// Narrow levels. A node hash may opt in to hashing one state on LANES
// neighbouring threads (`static constexpr int LANES` = WORDS, and
// `Word lanes(left, right, lane)`: lane k holds word k of each child and
// returns word k of the parent; every lane of the warp calls it, so that
// its warp shuffles take the whole warp). Then at a level where a block has
// at most THREADS / LANES parents, thread t hashes parent t / LANES as lane
// t % LANES, reading word t % LANES of the pair and writing that word of
// the parent (a warp with some such threads runs whole, its other lanes on
// zeros, and stores nothing of theirs); every other level, and every node
// hash without LANES, runs as above.
//
// Every level is written out: the query phase reads every layer. The
// pointers are not __restrict__: a stage reads the layer the one before it
// wrote through `out`.
//
// Cost: a block holds the 2 THREADS children of its first level in
// registers and its parents in WORDS x THREADS words of shared memory, 8 KB
// for either digest. The top of the tree runs on one block a group, one
// stage (3 hash latencies) after another. THREADS and STAGE were measured
// on the byte trees (scripts/torch_byte_tree_compare.py): 256 and 3 beat
// 128 or 64 threads and 1, 2 or 4 levels a stage.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace byte_tree {

constexpr int THREADS = 256;  // threads a block: parents of its first level
constexpr int STAGE = 3;      // levels a stage: 256, 128, 64 parents
constexpr int GROUP = 1 << STAGE;  // blocks of a stage handing on to one
static_assert((THREADS >> (STAGE - 1)) >= 32,
              "every level of a full stage fills its warps");

// Two neighbouring words of a shared plane, read as one load.
template <typename Word>
struct Pair;
template <>
struct Pair<uint32_t> {
  using type = uint2;
};
template <>
struct Pair<uint64_t> {
  using type = ulonglong2;
};

// LANES of a node hash: its own, or 1 when it does not opt in.
template <typename Hash, typename = void>
struct LanesOf {
  static constexpr int value = 1;
};
template <typename Hash>
struct LanesOf<Hash, decltype((void)Hash::LANES)> {
  static constexpr int value = Hash::LANES;
};

// A narrow level, the j-th of a stage (see "Narrow levels"): thread
// t < parents * LANES hashes parent t / LANES as lane k = t % LANES, from
// word k of its children (in the stage's input layer `src` of w digests
// from `first`, or in the shared slots) into word k of slot t / LANES and
// of the layer `out` (half = w / 2 digests).
template <typename Hash, typename Word = typename Hash::Word>
__device__ __forceinline__ void narrow_level(
    const Hash& hash, Word (&slot)[Hash::WORDS][THREADS], const uint64_t* src,
    uint64_t* out, long long w, long long half, long long first, int j,
    int parents, int t) {
  constexpr int LANES = Hash::LANES;
  const int q = t / LANES, k = t % LANES;
  const bool hashes = t < parents * LANES;
  typename Pair<Word>::type pair = {0, 0};
  if (hashes) {
    if (j == 0) {
      const ulonglong2 v = __ldcg(reinterpret_cast<const ulonglong2*>(
          src + k * w + first) + q);
      pair = {(Word)v.x, (Word)v.y};
    } else {
      pair = *reinterpret_cast<const typename Pair<Word>::type*>(
          &slot[k][2 * q]);
    }
  }
  __syncthreads();
  // the warp has a parent, so all of it takes part; a warp vote, so that
  // the compiler knows the warp converged (no per-shuffle collectives)
  if (__any_sync(~0u, hashes)) {
    const Word h = hash.lanes(pair.x, pair.y, k);
    if (hashes) {
      slot[k][q] = h;
      out[k * half + (first >> (j + 1)) + q] = h;
    }
  }
  __syncthreads();
}

// `hash(in, out)` is the node hash: in = left's WORDS words then right's,
// out = the parent's WORDS words.
template <typename Hash>
__device__ __forceinline__ void node_tree(const uint64_t* cur, uint64_t* out,
                                          long long m, int levels,
                                          unsigned* tickets, Hash hash) {
  constexpr int WORDS = Hash::WORDS;
  constexpr int LANES = LanesOf<Hash>::value;
  static_assert(LANES == 1 || LANES == WORDS, "a lane holds one word");
  using Word = typename Hash::Word;
  __shared__ __align__(16) Word slot[WORDS][THREADS];
  __shared__ bool goes_on;
  const int t = threadIdx.x;
  long long b = blockIdx.x;  // this block's index in its stage
  long long width = m;       // digests of the stage's input layer
  const uint64_t* src = cur;
  int done = 0;  // levels of the tree done by earlier stages
#pragma unroll 1
  for (;;) {
    const long long first = b * (2 * THREADS);
    int n = width - first < 2 * THREADS ? (int)(width - first) : 2 * THREADS;
    const int stage = levels - done < STAGE ? levels - done : STAGE;
    long long w = width;
#pragma unroll 1
    for (int j = 0; j < stage; ++j) {
      const int parents = n >> 1;
      const long long half = w >> 1;
      if constexpr (LANES > 1) {
        if (parents * LANES <= THREADS) {
          narrow_level(hash, slot, src, out, w, half, first, j, parents, t);
          src = out;
          out += WORDS * half;
          w = half;
          n = parents;
          continue;
        }
      }
      Word in[2 * WORDS];
      if (t < parents) {
        if (j == 0) {
#pragma unroll
          for (int k = 0; k < WORDS; ++k) {
            const ulonglong2 pair = __ldcg(reinterpret_cast<const ulonglong2*>(
                src + k * w + first) + t);
            in[k] = (Word)pair.x;
            in[WORDS + k] = (Word)pair.y;
          }
        } else {
#pragma unroll
          for (int k = 0; k < WORDS; ++k) {
            const typename Pair<Word>::type pair =
                *reinterpret_cast<const typename Pair<Word>::type*>(
                    &slot[k][2 * t]);
            in[k] = pair.x;
            in[WORDS + k] = pair.y;
          }
        }
      }
      __syncthreads();
      if (t < parents) {
        Word h[WORDS];
        hash(in, h);
        const long long p = (first >> (j + 1)) + t;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
          slot[k][t] = h[k];
          out[k * half + p] = h[k];
        }
      }
      __syncthreads();
      src = out;  // the layer just written
      out += WORDS * half;
      w = half;
      n = parents;
    }
    done += stage;
    if (done == levels) return;
    const long long blocks = (width + 2 * THREADS - 1) / (2 * THREADS);
    const long long group = b / GROUP;
    const long long members =
        blocks - group * GROUP < GROUP ? blocks - group * GROUP : GROUP;
    __threadfence();
    __syncthreads();
    if (t == 0)
      goes_on = atomicAdd(&tickets[group], 1u) == (unsigned)(members - 1);
    __syncthreads();
    if (!goes_on) return;
    __threadfence();
    tickets += (blocks + GROUP - 1) / GROUP;
    b = group;
    width = w;
  }
}

inline bool valid(long long m, int levels) {
  return levels >= 1 && levels < 63 && m >= 2 && m % (1LL << levels) == 0;
}

inline unsigned grid(long long m) {
  return (unsigned)((m + 2 * THREADS - 1) / (2 * THREADS));
}

}  // namespace byte_tree
