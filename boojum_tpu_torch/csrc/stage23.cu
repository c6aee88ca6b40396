// Stages 2 and 3 of a prove on the base domain: the copy-permutation grand
// product z, its G - 1 partial products and the lookup A / B polys, written
// as the (n, ldo) stage-2 Lagrange matrix (boojum_tpu_torch/prover/
// stage23.py: the column order, the math, the plain version).
//
// Replaces the reference's one compiled program for stages 2 and 3,
// boojum_tpu/prover/device_prover.py:1704 `_stage23_jit` (XLA fuses it; no
// Pallas kernel stands behind it). In eager torch the same work is about
// 266,000 launches of whole-column field ops a flagship prove.
//
// Two entries, one launch each:
//
// - stage23_rows. A row has I = G + (with lookups) nsub + 1 inverses, one a
//   "slot": slot k < G is chunk k's ratio num / den over its qd copy
//   columns, slot G + r lookup repetition r's A = sel / agg, the last slot
//   B = m / agg_t. Mapping: L lanes a row (L the power of two that gives
//   each lane at most ROUNDS slots; lane l takes slots l, l + L, ...), 32 / L
//   rows a warp. The flagship's 32 inverses: 8 lanes, 4 slots a lane, 4
//   rows a warp. The recursion outer circuit's 9: 4 lanes, 8 rows a warp.
//   A row with one inverse: one lane, 32 rows a warp. Up to 128 inverses a
//   row the build holds 4 slots a lane in registers, up to 512 the one of
//   16.
//   * Reads: the warp's rows are staged in shared memory by 8-byte
//     cp.async copies, neighbouring lanes at neighbouring addresses of a
//     row (the witness row's used columns, then the setup row's); beta *
//     k_j a copy column is made once a block there too. The lanes then
//     read their slots' columns from shared memory.
//   * One batch inversion a row, masked: each slot gives v and a norm n
//     (ratio = v / n with v = num * conj(den), n = den * conj(den) =
//     den0^2 - 7 den1^2; A = sel * conj(agg) / norm(agg); B likewise with
//     m). A zero norm (a zero element: 7 is no square) becomes 1; its v is
//     0 already, so the slot's result is 0 as the reference's 0 -> 0
//     inverse gives. A lane multiplies its norms (keeping their prefixes),
//     the row's lanes scan the lane products by shuffles both ways, every
//     lane of the row runs the one Fermat chain (INVERSE_CHAIN) on the row
//     product, and each lane walks its slots back for their inverses. So
//     a row has one chain, not I, and a warp's 32 / L rows share its
//     issue slots.
//   * Ext products by Karatsuba (3 multiplies); times 7 as a 96-bit
//     reduction; w + s * b + g as one product-and-sum reduction.
//   * Writes: each slot's result as one 16-byte store, the row's lanes on
//     neighbouring pairs: the ratio of chunk k < G - 1 into partial
//     column pair k + 1, A and B into their pairs; the row's total (the
//     product of its G ratios, by a butterfly over its lanes) into pair 0.
//     The ratios and the total are the scan's scratch.
//
// - stage23_scan: z, the exclusive GL2 prefix product of the totals, and
//   the partials z * r_0 * ... * r_c over the scratch, in one single-pass
//   launch (Merrill & Garland, "Single-pass Parallel Prefix Scan with
//   Decoupled Look-back", NVIDIA 2016). A block takes its tile index
//   (SCAN_TILE rows) from an atomic ticket, so every lower tile is already
//   resident; the last ticket resets the counter for the next call. A
//   thread a row: the block scans the rows' totals by warp shuffles and
//   one pass over its warps' products, then its first warp publishes the
//   tile's aggregate, reads its predecessors 32 * LOOK_TILES at a time
//   (aggregates down to the nearest inclusive prefix) and publishes its own
//   inclusive prefix, each behind a flag word stored with release and
//   loaded with acquire ordering. Flags carry the call's epoch (stage23.py
//   hands a new one to every call), so no status word is cleared between
//   calls: no memset, no extra launch. Each warp walks its 32 rows' z and
//   partial columns through shared memory, SCAN_COLS columns at a time,
//   read by cp.async (the next stage in flight while one is worked; the
//   first stage, which holds the totals, before the scan) and written
//   coalesced; a thread carries its row's running product. A block reads
//   and writes only its own rows, so the in-place scratch is safe.
//
// The arithmetic is goldilocks.cuh's lazy family (any uint64_t in, a
// congruent uint64_t out); the norms tested for zero and every value stored
// are canonicalized, as the outputs are hashed next.
//
// Bound: the bytes. A flagship row (92 copy columns in 23 chunks, 8 lookup
// repetitions) reads and writes about 2 KB: over 2^16 rows 0.040 ms at
// 3.35 TB/s. Its function needs about 1,300 field multiplies a row (one
// batch inversion of the row's 32 norms that masks zeros, Karatsuba ext
// products; chip_smoke.py stage23_row_muls), 0.020 ms at 4 INT32
// multiply-adds each. The earlier design, one thread a row with a Fermat
// chain an inverse (32 a row, 16 warps an SM), took 0.62 ms: 0.32 ms of it
// the chains, 0.04 ms the strided reads (PERF.md). This design runs at about
// 0.25 ms on an H100: integer issue, not latency, now bounds it (a variant
// without its one chain a row saves 0.05 ms). The scan's bound is its
// bytes, the z and partial columns read and written once; it runs at about
// 0.03 ms (its look-back took about 0.007 ms with 256-row tiles and
// 32-tile windows).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "ext2.cuh"
#include "goldilocks.cuh"

namespace {

using gl::affine;
using gl::E2;
using gl::e2_mul;
using gl::e2_scale;
using gl::mul7;
using gl::mul_add2;

constexpr int MAX_TID = 64;       // stage23.py MAX_TID
constexpr int ROW_THREADS = 128;
constexpr int ROW_WARPS = ROW_THREADS / 32;
// slots a lane in the two builds of the row kernel
constexpr int ROUNDS_SMALL = 4, ROUNDS_LARGE = 16;
constexpr int SCAN_THREADS = 512;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_TILE = SCAN_THREADS;  // a row a thread; stage23.py SCAN_TILE
// u64 columns of a row the scan stages at a time, two stages in flight; a
// row's stride in shared memory odd, so a warp's 64-bit reads of its 32
// rows hit 32 banks apiece
constexpr int SCAN_COLS = 16, SCAN_STRIDE = SCAN_COLS + 1;
constexpr int SCAN_BUF = SCAN_WARPS * 32 * SCAN_STRIDE;  // u64 a stage
// status words (stage23.py `scan_status`): the ticket counter, then
// STATUS_WORDS a tile: flag, aggregate c0 c1, inclusive prefix c0 c1
constexpr int STATUS_HEAD = 8, STATUS_WORDS = 8;
constexpr uint64_t FLAG_AGGREGATE = 1, FLAG_INCLUSIVE = 2;
constexpr int LOOK_TILES = 4;  // tiles a lane reads in a look-back window
constexpr unsigned FULL = 0xFFFFFFFFu;

// The host's int64 parameter array, in stage23.py `row_params` order, and
// what the launcher derives from it.
constexpr int NUM_PARAMS = 15 + MAX_TID;
struct RowParams {
  long long n, ldw, lds, ldo;
  int num_var, qd, lookup, nsub, pw, base_off, width, ntid, table_off, ntab,
      mult_col;
  int tid[MAX_TID];
  int chunks, inverses, lanes, log_lanes, wcols, scols;
};

__device__ __forceinline__ E2 e2_one() { return E2{1, 0}; }

// Lazy arithmetic (goldilocks.cuh: any uint64_t in, some uint64_t congruent
// out); the values compared with 0 and the values stored are canonicalized.
__device__ __forceinline__ E2 e2_canon(E2 a) {
  return E2{gl::canonicalize(a.c0), gl::canonicalize(a.c1)};
}

// a * conj(b) = (a0 + a1 u)(b0 - b1 u), by Karatsuba
__device__ __forceinline__ E2 e2_mul_conj(E2 a, E2 b) {
  const uint64_t v0 = gl::mul_lazy(a.c0, b.c0), v1 = gl::mul_lazy(a.c1, b.c1);
  const uint64_t s =
      gl::mul_lazy(gl::add_lazy(a.c0, a.c1), gl::sub_lazy(b.c0, b.c1));
  return E2{gl::sub_lazy(v0, mul7(v1)), gl::add_lazy(gl::sub_lazy(s, v0), v1)};
}

__device__ __forceinline__ E2 e2_conj(E2 a) {
  return E2{a.c0, gl::sub_lazy(0, a.c1)};
}

// a * conj(a) = a0^2 - 7 a1^2: zero (mod p) only for a = 0
__device__ __forceinline__ uint64_t e2_norm(E2 a) {
  return gl::sub_lazy(gl::square_lazy(a.c0), mul7(gl::square_lazy(a.c1)));
}

__device__ __forceinline__ uint64_t sqn(uint64_t x, int k) {
  for (int i = 0; i < k; ++i) x = gl::square_lazy(x);
  return x;
}

// x^(p-2), p - 2 = 0b(31 ones) 0 (32 ones): stage23.py INVERSE_CHAIN;
// canonical
__device__ uint64_t inverse(uint64_t x) {
  const uint64_t t2 = gl::mul_lazy(sqn(x, 1), x);
  const uint64_t t3 = gl::mul_lazy(sqn(t2, 1), x);
  const uint64_t t6 = gl::mul_lazy(sqn(t3, 3), t3);
  const uint64_t t12 = gl::mul_lazy(sqn(t6, 6), t6);
  const uint64_t t24 = gl::mul_lazy(sqn(t12, 12), t12);
  const uint64_t t30 = gl::mul_lazy(sqn(t24, 6), t6);
  const uint64_t t31 = gl::mul_lazy(sqn(t30, 1), x);
  const uint64_t t63 = gl::mul_lazy(sqn(t31, 32), t31);
  return gl::canonicalize(gl::mul_lazy(sqn(t63, 1), x));
}

// acc + b * g for a base b and the ext scalar at g[0], g[1]
__device__ __forceinline__ E2 add_scaled(E2 acc, uint64_t b,
                                         const uint64_t* g) {
  return E2{mul_add2(b, g[0], acc.c0, 0), mul_add2(b, g[1], acc.c1, 0)};
}

// --- memory access -------------------------------------------------------

__device__ __forceinline__ void copy_async8(uint64_t* dst,
                                            const uint64_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest committed group landed
__device__ __forceinline__ void copy_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void store_pair(uint64_t* dst, E2 v) {
  *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(v.c0, v.c1);
}

// rows i0 .. i0 + rows - 1 (those below n) of a row-major matrix with row
// stride ld, columns [0, cols), into dst (rows x cols), the warp's lanes on
// neighbouring columns
__device__ __forceinline__ void stage_rows(uint64_t* dst, const uint64_t* src,
                                           long long i0, int rows, int cols,
                                           long long ld, long long n,
                                           int lane) {
  for (int r = 0; r < rows && i0 + r < n; ++r)
    for (int c = lane; c < cols; c += 32)
      copy_async8(dst + r * cols + c, src + (i0 + r) * ld + c);
}

// --- stage23_rows ----------------------------------------------------------

// The challenges: beta, gamma, beta * k_j a copy column (bk[2j], bk[2j +
// 1], in shared memory), the lookup's beta and its gamma powers (gamma^t at
// g[2t], g[2t + 1])
struct Challenges {
  E2 beta, gamma, lbeta;
  const uint64_t* bk;
  const uint64_t* g;
};

// Slot k of a row (w, s: its staged witness and setup columns): v and the
// norm n with result v / n.
__device__ __forceinline__ void slot_value(
    int k, const RowParams& p, const uint64_t* w, const uint64_t* s,
    uint64_t xi, const Challenges& ch, const uint64_t* sel_row, E2& v,
    uint64_t& norm) {
  const E2 beta = ch.beta, gamma = ch.gamma;
  if (k < p.chunks) {
    // w + (beta k_j) x + gamma over w + beta sigma_j + gamma
    const int start = k * p.qd, end = min(start + p.qd, p.num_var);
    const uint64_t* bk = ch.bk;
    E2 num = affine(w[start], xi, E2{bk[2 * start], bk[2 * start + 1]}, gamma);
    E2 den = affine(w[start], s[start], beta, gamma);
#pragma unroll 4
    for (int j = start + 1; j < end; ++j) {
      const uint64_t wj = w[j];
      num = e2_mul(num, affine(wj, xi, E2{bk[2 * j], bk[2 * j + 1]}, gamma));
      den = e2_mul(den, affine(wj, s[j], beta, gamma));
    }
    v = e2_mul_conj(num, den);
    norm = e2_norm(den);
    return;
  }
  const uint64_t* g = ch.g;
  const int rep = k - p.chunks;
  const bool table = rep == p.nsub;
  const uint64_t* src = table ? s + p.table_off : w + p.base_off + rep * p.pw;
  const int cols = table ? p.ntab : p.pw;
  E2 agg = ch.lbeta;
  for (int t = 0; t < cols; ++t) agg = add_scaled(agg, src[t], g + 2 * t);
  if (!table && p.ntid)
    agg = add_scaled(agg, s[p.tid[min(rep, p.ntid - 1)]], g + 2 * p.width);
  v = e2_conj(agg);
  if (table) v = e2_scale(v, w[p.mult_col]);
  else if (sel_row) v = e2_scale(v, *sel_row);
  norm = e2_norm(agg);
}

// scal: beta, gamma, then (with lookups) beta_l and gamma^0 .. gamma^t, each
// as c0, c1
template <int ROUNDS>
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const uint64_t* __restrict__ wit,
                const uint64_t* __restrict__ setup,
                const uint64_t* __restrict__ x,
                const uint64_t* __restrict__ nonres,
                const uint64_t* __restrict__ scal,
                const uint64_t* __restrict__ sel, uint64_t* __restrict__ out,
                const RowParams p) {
  // shared: beta * k_j for the copy columns, then each warp's rows
  extern __shared__ uint64_t staged[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = p.lanes, rows = 32 >> p.log_lanes;
  const int li = lane & (L - 1), rr = lane >> p.log_lanes;
  const long long i0 = ((long long)blockIdx.x * ROW_WARPS + warp) * rows;
  uint64_t* bk = staged;
  uint64_t* sw = staged + 2 * p.num_var + warp * rows * (p.wcols + p.scols);
  uint64_t* ss = sw + rows * p.wcols;
  stage_rows(sw, wit, i0, rows, p.wcols, p.ldw, p.n, lane);
  stage_rows(ss, setup, i0, rows, p.scols, p.lds, p.n, lane);
  Challenges ch{{scal[0], scal[1]}, {scal[2], scal[3]}, {0, 0}, bk, scal + 6};
  if (p.lookup) ch.lbeta = E2{scal[4], scal[5]};
  for (int j = threadIdx.x; j < p.num_var; j += ROW_THREADS) {
    const E2 b = e2_scale(ch.beta, nonres[j]);
    bk[2 * j] = b.c0;
    bk[2 * j + 1] = b.c1;
  }
  copy_async_wait();
  __syncthreads();

  const long long i = i0 + rr;
  const bool live = i < p.n;
  const uint64_t* w = sw + rr * p.wcols;
  const uint64_t* s = ss + rr * p.scols;
  const uint64_t xi = live ? x[i] : 0;
  const uint64_t* sel_row = sel ? sel + (live ? i : 0) : nullptr;

  // each slot's v and masked norm, the lane's norm prefixes and product
  E2 v[ROUNDS];
  uint64_t norm[ROUNDS], before[ROUNDS];
  uint64_t prod = 1;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = r * L + li;
    E2 vk{0, 0};
    uint64_t nk = 1;
    if (live && k < p.inverses) {
      slot_value(k, p, w, s, xi, ch, sel_row, vk, nk);
      nk = gl::canonicalize(nk);
      if (nk == 0) nk = 1;  // a zero element: vk is 0, the result 0
    }
    v[r] = vk;
    norm[r] = nk;
    before[r] = prod;
    prod = r ? gl::mul_lazy(prod, nk) : nk;
  }

  // the row's lanes: inclusive prefix and suffix products of the lanes'
  // products, the row product, its one inverse, this lane's share of it
  uint64_t pre = prod, suf = prod;
  for (int d = 1; d < L; d <<= 1) {
    const uint64_t a = __shfl_up_sync(FULL, pre, d, L);
    const uint64_t b = __shfl_down_sync(FULL, suf, d, L);
    pre = gl::mul_lazy(pre, li >= d ? a : 1);
    suf = gl::mul_lazy(suf, li + d < L ? b : 1);
  }
  const uint64_t row_prod = __shfl_sync(FULL, pre, L - 1, L);
  const uint64_t lo = __shfl_up_sync(FULL, pre, 1, L);
  const uint64_t hi = __shfl_down_sync(FULL, suf, 1, L);
  uint64_t inv = gl::mul_lazy(inverse(row_prod), li ? lo : 1);
  inv = gl::mul_lazy(inv, li + 1 < L ? hi : 1);  // 1 / prod

  // the slots backwards: result = v / norm; the chunks' ratios multiplied
  uint64_t* o = out + i * p.ldo;
  E2 total = e2_one();
#pragma unroll
  for (int r = ROUNDS - 1; r >= 0; --r) {
    const int k = r * L + li;
    const uint64_t inv_k = r ? gl::mul_lazy(inv, before[r]) : inv;
    if (r) inv = gl::mul_lazy(inv, norm[r]);
    if (live && k < p.inverses) {
      const E2 res = e2_canon(e2_scale(v[r], inv_k));
      if (k < p.chunks) total = e2_mul(total, res);
      if (k != p.chunks - 1) store_pair(o + 2 * (k < p.chunks ? k + 1 : k),
                                        res);
    }
  }
  for (int d = 1; d < L; d <<= 1) {
    const E2 other{__shfl_xor_sync(FULL, total.c0, d, L),
                   __shfl_xor_sync(FULL, total.c1, d, L)};
    total = e2_mul(total, other);
  }
  if (live && li == 0) store_pair(o, e2_canon(total));
}

// --- stage23_scan ----------------------------------------------------------

__device__ __forceinline__ E2 shfl_up_e2(E2 v, int d) {
  return E2{__shfl_up_sync(FULL, v.c0, d), __shfl_up_sync(FULL, v.c1, d)};
}

// tile t's flag, aggregate and inclusive prefix
__device__ __forceinline__ uint64_t* tile_status(uint64_t* status,
                                                 long long t) {
  return status + STATUS_HEAD + t * STATUS_WORDS;
}

// The product of v over the warp's 32 lanes, on every lane.
__device__ __forceinline__ E2 warp_product(E2 v) {
  for (int d = 1; d < 32; d <<= 1)
    v = e2_mul(v, E2{__shfl_xor_sync(FULL, v.c0, d),
                     __shfl_xor_sync(FULL, v.c1, d)});
  return v;
}

// Warp 0 of tile t: lane 0 publishes the tile's aggregate; the lanes read
// the status of the 32 * LOOK_TILES tiles below a window's end at once,
// LOOK_TILES each (waiting for each tile's flag of this epoch), multiply
// the aggregates down to the nearest inclusive prefix, and move the window
// down until they meet one; lane 0 publishes the tile's inclusive prefix.
// Returns the exclusive prefix on every lane.
__device__ E2 look_back(uint64_t* status, long long t, E2 agg,
                        uint64_t epoch, int lane) {
  uint64_t* st = tile_status(status, t);
  E2 prefix = e2_one();
  if (t > 0) {
    if (lane == 0) {
      store_relaxed(st + 1, agg.c0);
      store_relaxed(st + 2, agg.c1);
      store_release(st, epoch << 2 | FLAG_AGGREGATE);
    }
    for (long long end = t;; end -= 32 * LOOK_TILES) {
      // the lane's tiles from q0; lane 31's last is the nearest
      const long long q0 = end - 32 * LOOK_TILES + (long long)lane * LOOK_TILES;
      int mine = -1;  // the lane's nearest inclusive prefix
#pragma unroll
      for (int k = 0; k < LOOK_TILES; ++k) {
        if (q0 + k < 0) continue;
        uint64_t flag;
        while (((flag = load_acquire(tile_status(status, q0 + k))) >> 2) !=
               epoch)
          __nanosleep(20);
        if ((flag & 3) == FLAG_INCLUSIVE) mine = k;
      }
      const unsigned incl = __ballot_sync(FULL, mine >= 0);
      const int top = incl ? 31 - __clz(incl) : 0;  // the nearest inclusive
      E2 v = e2_one();
      if (lane >= top) {
#pragma unroll
        for (int k = 0; k < LOOK_TILES; ++k) {
          if (q0 + k < 0 || (lane == top && k < mine)) continue;
          const uint64_t* sq = tile_status(status, q0 + k);
          const int at = lane == top && k == mine ? 3 : 1;
          v = e2_mul(v, E2{load_relaxed(sq + at), load_relaxed(sq + at + 1)});
        }
      }
      prefix = e2_mul(warp_product(v), prefix);
      if (incl) break;
    }
  }
  if (lane == 0) {
    const E2 incl = e2_mul(prefix, agg);
    store_relaxed(st + 3, incl.c0);
    store_relaxed(st + 4, incl.c1);
    store_release(st, epoch << 2 | FLAG_INCLUSIVE);
  }
  return prefix;
}

// Columns [c0, c0 + cw) of a warp's 32 rows from row0 (those below n) of
// the output into its stage buffer (row r at r * SCAN_STRIDE), one group of
// copies
__device__ __forceinline__ void stage_cols(uint64_t* buf, const uint64_t* out,
                                           long long row0, long long n,
                                           long long ldo, int c0, int cw,
                                           int lane) {
  for (int f = lane; f < 32 * SCAN_COLS; f += 32) {
    const int r = f / SCAN_COLS, c = f % SCAN_COLS;
    if (c < cw && row0 + r < n)
      copy_async8(buf + r * SCAN_STRIDE + c, out + (row0 + r) * ldo + c0 + c);
  }
  copy_async_commit();
}

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(uint64_t* __restrict__ out, uint64_t* __restrict__ status,
                long long n, int chunks, long long ldo, uint64_t epoch,
                long long tiles) {
  extern __shared__ uint64_t stages[];  // two stage buffers
  __shared__ E2 warp_prefix[SCAN_WARPS];
  __shared__ E2 tile_prefix;
  __shared__ long long tile_index;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    const long long ticket = (long long)atomicAdd(
        reinterpret_cast<unsigned long long*>(status), 1ull);
    if (ticket == tiles - 1)  // every ticket of this call is taken
      atomicExch(reinterpret_cast<unsigned long long*>(status), 0ull);
    tile_index = ticket;
  }
  __syncthreads();
  const long long tile = tile_index;
  const long long row0 = tile * SCAN_TILE + (long long)warp * 32;
  const long long i = row0 + lane;  // the thread's row
  // the row's z and partial columns (2 * chunks u64) in stages of
  // SCAN_COLS, the next stage's copies in flight while one is worked
  const int width = 2 * chunks, nstages = (width + SCAN_COLS - 1) / SCAN_COLS;
  uint64_t* buf[2] = {stages + warp * 32 * SCAN_STRIDE,
                      stages + SCAN_BUF + warp * 32 * SCAN_STRIDE};
  stage_cols(buf[0], out, row0, n, ldo, 0, min(SCAN_COLS, width), lane);
  if (nstages > 1)
    stage_cols(buf[1], out, row0, n, ldo, SCAN_COLS,
               min(SCAN_COLS, width - SCAN_COLS), lane);
  else
    copy_async_commit();
  copy_async_wait_but_one();
  __syncwarp();

  uint64_t* e = buf[0] + lane * SCAN_STRIDE;
  E2 incl = i < n ? E2{e[0], e[1]} : e2_one();  // the row's total
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const E2 other = shfl_up_e2(incl, d);
    if (lane >= d) incl = e2_mul(other, incl);
  }
  E2 excl = shfl_up_e2(incl, 1);
  if (lane == 0) excl = e2_one();
  if (lane == 31) warp_prefix[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    E2 agg = e2_one();  // the warps' exclusive prefixes, the tile's product
    for (int w = 0; w < SCAN_WARPS; ++w) {
      const E2 sw = warp_prefix[w];
      __syncwarp();
      if (lane == 0) warp_prefix[w] = agg;
      agg = e2_mul(agg, sw);
    }
    const E2 prefix = look_back(status, tile, agg, epoch, lane);
    if (lane == 0) tile_prefix = prefix;
  }
  __syncthreads();

  // z, then the partials over the ratios
  E2 part = e2_mul(e2_mul(tile_prefix, warp_prefix[warp]), excl);
  for (int st = 0; st < nstages; ++st) {
    uint64_t* b = buf[st & 1];
    if (st) {
      copy_async_wait_but_one();
      __syncwarp();
    }
    const int c0 = st * SCAN_COLS, cw = min(SCAN_COLS, width - c0);
    if (i < n) {
      e = b + lane * SCAN_STRIDE;
      for (int c = 0; c < cw; c += 2) {
        if (c0 + c) part = e2_mul(part, E2{e[c], e[c + 1]});
        e[c] = gl::canonicalize(part.c0);
        e[c + 1] = gl::canonicalize(part.c1);
      }
    }
    __syncwarp();
    for (int f = lane; f < 32 * SCAN_COLS; f += 32) {
      const int r = f / SCAN_COLS, c = f % SCAN_COLS;
      if (c < cw && row0 + r < n)
        out[(row0 + r) * ldo + c0 + c] = b[r * SCAN_STRIDE + c];
    }
    __syncwarp();
    if (st + 2 < nstages)
      stage_cols(b, out, row0, n, ldo, c0 + 2 * SCAN_COLS,
                 min(SCAN_COLS, width - c0 - 2 * SCAN_COLS), lane);
    else
      copy_async_commit();
  }
}

constexpr int MAX_DEVICES = 64;

// Lets kernel K launch with ``bytes`` of dynamic shared memory on the
// current device: the attribute is set once a device for the largest size
// asked (above the 48 KB every kernel may take).
template <auto K>
cudaError_t allow_shared(size_t bytes) {
  static size_t granted[MAX_DEVICES] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < MAX_DEVICES && granted[dev] >= bytes) return cudaSuccess;
  rc = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)bytes);
  if (rc == cudaSuccess && dev < MAX_DEVICES) granted[dev] = bytes;
  return rc;
}

template <int ROUNDS>
int launch_rows(const void* wit, const void* setup, const void* x,
                const void* nonres, const void* scal, const void* sel,
                void* out, const RowParams& p, cudaStream_t stream) {
  const int rows = ROW_WARPS * (32 >> p.log_lanes);
  const size_t smem = sizeof(uint64_t) *
                      (2 * (size_t)p.num_var + rows * (size_t)(p.wcols + p.scols));
  const cudaError_t rc = allow_shared<rows_kernel<ROUNDS>>(smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long blocks = (p.n + rows - 1) / rows;
  rows_kernel<ROUNDS><<<(unsigned)blocks, ROW_THREADS, smem, stream>>>(
      (const uint64_t*)wit, (const uint64_t*)setup, (const uint64_t*)x,
      (const uint64_t*)nonres, (const uint64_t*)scal, (const uint64_t*)sel,
      (uint64_t*)out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// params: stage23.py `row_params` (NUM_PARAMS int64 values, read before the
// call returns); sel may be null
extern "C" int stage23_rows(const void* wit, const void* setup, const void* x,
                            const void* nonres, const void* scal,
                            const void* sel, void* out,
                            const long long* params, void* stream) {
  const long long* q = params;
  RowParams p;
  p.n = q[0];
  p.num_var = (int)q[1];
  p.qd = (int)q[2];
  p.ldw = q[3];
  p.lds = q[4];
  p.ldo = q[5];
  p.lookup = (int)q[6];
  p.nsub = (int)q[7];
  p.pw = (int)q[8];
  p.base_off = (int)q[9];
  p.width = (int)q[10];
  p.ntid = (int)q[11];
  p.table_off = (int)q[12];
  p.ntab = (int)q[13];
  p.mult_col = (int)q[14];
  static_assert(NUM_PARAMS == 15 + MAX_TID, "parameter count");
  for (int k = 0; k < MAX_TID; ++k) p.tid[k] = (int)q[15 + k];
  if (p.n <= 0 || p.num_var <= 0 || p.qd <= 0 || p.ntid > MAX_TID)
    return (int)cudaErrorInvalidValue;
  p.chunks = (p.num_var + p.qd - 1) / p.qd;
  p.inverses = p.chunks + (p.lookup ? p.nsub + 1 : 0);
  // the columns a row reads: the copy columns, and with lookups the
  // repetitions' columns and the multiplicity, the ids and the table
  p.wcols = p.scols = p.num_var;
  if (p.lookup) {
    p.wcols = std::max(p.wcols, std::max(p.base_off + p.nsub * p.pw,
                                         p.mult_col + 1));
    p.scols = std::max(p.scols, p.table_off + p.ntab);
    for (int k = 0; k < p.ntid; ++k) p.scols = std::max(p.scols, p.tid[k] + 1);
  }
  if (2LL * p.inverses != p.ldo || p.wcols > p.ldw || p.scols > p.lds)
    return (int)cudaErrorInvalidValue;
  const int rounds = p.inverses <= 32 * ROUNDS_SMALL ? ROUNDS_SMALL
                                                     : ROUNDS_LARGE;
  if (p.inverses > 32 * rounds) return (int)cudaErrorInvalidValue;
  p.log_lanes = 0;
  while ((1 << p.log_lanes) * rounds < p.inverses) ++p.log_lanes;
  p.lanes = 1 << p.log_lanes;
  cudaStream_t st = (cudaStream_t)stream;
  return rounds == ROUNDS_SMALL
             ? launch_rows<ROUNDS_SMALL>(wit, setup, x, nonres, scal, sel,
                                         out, p, st)
             : launch_rows<ROUNDS_LARGE>(wit, setup, x, nonres, scal, sel,
                                         out, p, st);
}

// out: the row kernel's output (n, ldo); status: stage23.py `scan_status`'s
// words (STATUS_HEAD + STATUS_WORDS * ceil(n / SCAN_TILE) zeroed u64 at
// first use, the counter back at 0 after every call); epoch: larger than
// every epoch this status buffer has seen
extern "C" int stage23_scan(void* out, void* status, long long n, int chunks,
                            long long ldo, long long epoch, void* stream) {
  if (n <= 0 || chunks <= 0 || 2LL * chunks > ldo || !status || epoch <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  const size_t smem = sizeof(uint64_t) * 2 * SCAN_BUF;
  const cudaError_t rc = allow_shared<scan_kernel>(smem);
  if (rc != cudaSuccess) return (int)rc;
  scan_kernel<<<(unsigned)tiles, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      (uint64_t*)out, (uint64_t*)status, n, chunks, ldo, (uint64_t)epoch,
      tiles);
  return (int)cudaGetLastError();
}
