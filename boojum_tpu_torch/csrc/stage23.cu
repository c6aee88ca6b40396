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
// Two entries:
// - stage23_rows: one thread a row. For each chunk of qd copy columns the
//   products of (w + beta*k_j*x + gamma) and (w + beta*sigma_j + gamma), the
//   chunk's ratio num / den and the row's total (the product of the
//   ratios); each lookup repetition's aggregate beta_l + sum gamma^i*col_i
//   (+ gamma^width * table id) inverted (times sel in the general-purpose
//   modes), and the table aggregate's inverse times the multiplicity. The A
//   and B columns go straight into the output; the ratios of chunks
//   0 .. G-2 and the total go into the partial and z columns as scratch.
// - stage23_scan: the exclusive GL2 prefix product of the totals over the n
//   rows, in blocks of SCAN_BLOCK rows: block products, one block's scan of
//   them, then each block scans its rows from its prefix and writes z and
//   the partials z * r_0 * ... * r_c over the scratch (three launches; one
//   when n fits a block). Each thread reads and writes only its own row of
//   the output, so the in-place scratch is safe.
//
// Every inverse is Fermat's x^(p-2) of the element's norm by one addition
// chain (63 squarings, 9 multiplies; stage23.py INVERSE_CHAIN), so 0 maps
// to 0 element by element: no batch inversion whose one zero would poison
// a row. All arithmetic is canonical (goldilocks.cuh add / sub / mul), as
// the outputs are hashed next.
//
// Bound: the bytes. A flagship row (92 copy columns in 23 chunks, 8 lookup
// repetitions) reads and writes about 2 KB: over 2^16 rows 0.040 ms at
// 3.35 TB/s. Its function needs about 1,300 field multiplies a row (one
// batch inversion of the row's 32 norms that masks zeros, Karatsuba ext
// products; chip_smoke.py stage23_row_muls), 0.020 ms at 4 INT32
// multiply-adds each. This kernel does about 4,200 a row, 2,464 of them in
// its 32 Fermat chains. Nothing here is tuned yet: one thread a row reads
// its row of the row-major witness and setup with a stride, and runs its
// inverses as dependent chains (about 6 % of the bound on an H100).
#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_TID = 64;       // stage23.py MAX_TID
constexpr int SCAN_BLOCK = 256;   // stage23.py SCAN_BLOCK
constexpr int ROW_THREADS = 128;

// The host's int64 parameter array, in stage23.py `row_params` order.
constexpr int NUM_PARAMS = 15 + MAX_TID;
struct RowParams {
  long long n, ldw, lds, ldo;
  int num_var, qd, lookup, nsub, pw, base_off, width, ntid, table_off, ntab,
      mult_col;
  int tid[MAX_TID];
};

struct E2 {
  uint64_t c0, c1;
};

__device__ __forceinline__ E2 e2_one() { return E2{1, 0}; }

// (a0 + a1 u)(b0 + b1 u) with u^2 = 7
__device__ __forceinline__ E2 e2_mul(E2 a, E2 b) {
  const uint64_t v0 = gl::mul(a.c0, b.c0), v1 = gl::mul(a.c1, b.c1);
  return E2{gl::add(v0, gl::mul(v1, 7)),
            gl::add(gl::mul(a.c0, b.c1), gl::mul(a.c1, b.c0))};
}

__device__ __forceinline__ uint64_t sqn(uint64_t x, int k) {
  for (int i = 0; i < k; ++i) x = gl::mul(x, x);
  return x;
}

// x^(p-2), p - 2 = 0b(31 ones) 0 (32 ones); 0 -> 0
__device__ uint64_t inverse(uint64_t x) {
  const uint64_t t2 = gl::mul(sqn(x, 1), x);
  const uint64_t t3 = gl::mul(sqn(t2, 1), x);
  const uint64_t t6 = gl::mul(sqn(t3, 3), t3);
  const uint64_t t12 = gl::mul(sqn(t6, 6), t6);
  const uint64_t t24 = gl::mul(sqn(t12, 12), t12);
  const uint64_t t30 = gl::mul(sqn(t24, 6), t6);
  const uint64_t t31 = gl::mul(sqn(t30, 1), x);
  const uint64_t t63 = gl::mul(sqn(t31, 32), t31);
  return gl::mul(sqn(t63, 1), x);
}

// (c0 - c1 u) / (c0^2 - 7 c1^2); 0 -> 0
__device__ __forceinline__ E2 e2_inv(E2 a) {
  const uint64_t norm =
      gl::sub(gl::mul(a.c0, a.c0), gl::mul(gl::mul(a.c1, a.c1), 7));
  const uint64_t inv = inverse(norm);
  return E2{gl::mul(a.c0, inv), gl::sub(0, gl::mul(a.c1, inv))};
}

// w + beta*s + gamma
__device__ __forceinline__ E2 affine(uint64_t w, uint64_t s, E2 beta,
                                     E2 gamma) {
  return E2{gl::add(gl::add(w, gl::mul(s, beta.c0)), gamma.c0),
            gl::add(gl::mul(s, beta.c1), gamma.c1)};
}

// acc + b * g for a base b and the ext scalar at g[0], g[1]
__device__ __forceinline__ E2 add_scaled(E2 acc, uint64_t b,
                                         const uint64_t* g) {
  return E2{gl::add(acc.c0, gl::mul(b, g[0])),
            gl::add(acc.c1, gl::mul(b, g[1]))};
}

// scal: beta, gamma, then (with lookups) beta_l and gamma^0 .. gamma^t, each
// as c0, c1
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const uint64_t* __restrict__ wit,
                const uint64_t* __restrict__ setup,
                const uint64_t* __restrict__ x,
                const uint64_t* __restrict__ nonres,
                const uint64_t* __restrict__ scal,
                const uint64_t* __restrict__ sel, uint64_t* __restrict__ out,
                const RowParams p) {
  const long long i = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  if (i >= p.n) return;
  const uint64_t* w = wit + i * p.ldw;
  const uint64_t* s = setup + i * p.lds;
  uint64_t* o = out + i * p.ldo;
  const E2 beta{scal[0], scal[1]}, gamma{scal[2], scal[3]};
  const uint64_t xi = x[i];
  const int chunks = (p.num_var + p.qd - 1) / p.qd;

  E2 total = e2_one();
  for (int c = 0; c < chunks; ++c) {
    E2 num = e2_one(), den = e2_one();
    const int end = min((c + 1) * p.qd, p.num_var);
    for (int j = c * p.qd; j < end; ++j) {
      const uint64_t wj = w[j];
      num = e2_mul(num, affine(wj, gl::mul(xi, nonres[j]), beta, gamma));
      den = e2_mul(den, affine(wj, s[j], beta, gamma));
    }
    const E2 r = e2_mul(num, e2_inv(den));
    total = e2_mul(total, r);
    if (c + 1 < chunks) {
      o[2 + 2 * c] = r.c0;
      o[3 + 2 * c] = r.c1;
    }
  }
  o[0] = total.c0;
  o[1] = total.c1;
  if (!p.lookup) return;

  const E2 lbeta{scal[4], scal[5]};
  const uint64_t* gp = scal + 6;  // gamma^t at gp[2t], gp[2t + 1]
  uint64_t* oa = o + 2 * chunks;
  for (int rep = 0; rep < p.nsub; ++rep) {
    E2 agg = lbeta;
    const uint64_t* lc = w + p.base_off + rep * p.pw;
    for (int t = 0; t < p.pw; ++t) agg = add_scaled(agg, lc[t], gp + 2 * t);
    if (p.ntid)
      agg = add_scaled(agg, s[p.tid[min(rep, p.ntid - 1)]], gp + 2 * p.width);
    E2 a = e2_inv(agg);
    if (sel) {
      const uint64_t sv = sel[i];
      a = E2{gl::mul(a.c0, sv), gl::mul(a.c1, sv)};
    }
    oa[2 * rep] = a.c0;
    oa[2 * rep + 1] = a.c1;
  }
  E2 agg = lbeta;
  for (int t = 0; t < p.ntab; ++t)
    agg = add_scaled(agg, s[p.table_off + t], gp + 2 * t);
  const E2 b = e2_inv(agg);
  const uint64_t m = w[p.mult_col];
  oa[2 * p.nsub] = gl::mul(b.c0, m);
  oa[2 * p.nsub + 1] = gl::mul(b.c1, m);
}

// The block's inclusive prefix products of v (one value a thread, every
// thread of the block taking part); sh[t] holds thread t's on return.
__device__ E2 inclusive_scan(E2* sh, E2 v) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int d = 1; d < SCAN_BLOCK; d <<= 1) {
    const E2 other = t >= d ? sh[t - d] : e2_one();
    __syncthreads();
    v = e2_mul(other, v);
    sh[t] = v;
    __syncthreads();
  }
  return v;
}

__device__ __forceinline__ E2 row_total(const uint64_t* out, long long i,
                                        long long n, long long ldo) {
  return i < n ? E2{out[i * ldo], out[i * ldo + 1]} : e2_one();
}

// phase 1: the product of each block's totals
__global__ void __launch_bounds__(SCAN_BLOCK)
    block_products(const uint64_t* __restrict__ out,
                   uint64_t* __restrict__ prods, long long n, long long ldo) {
  __shared__ E2 sh[SCAN_BLOCK];
  const int t = threadIdx.x;
  sh[t] = row_total(out, (long long)blockIdx.x * SCAN_BLOCK + t, n, ldo);
  __syncthreads();
  for (int h = SCAN_BLOCK / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] = e2_mul(sh[t], sh[t + h]);
    __syncthreads();
  }
  if (t == 0) {
    prods[2 * blockIdx.x] = sh[0].c0;
    prods[2 * blockIdx.x + 1] = sh[0].c1;
  }
}

// phase 2, one block: the block products -> their exclusive prefixes, in
// place, SCAN_BLOCK at a time with a carry
__global__ void __launch_bounds__(SCAN_BLOCK)
    scan_products(uint64_t* __restrict__ prods, long long nb) {
  __shared__ E2 sh[SCAN_BLOCK];
  const int t = threadIdx.x;
  E2 carry = e2_one();
  for (long long base = 0; base < nb; base += SCAN_BLOCK) {
    const long long b = base + t;
    const E2 v = b < nb ? E2{prods[2 * b], prods[2 * b + 1]} : e2_one();
    inclusive_scan(sh, v);
    const E2 excl = e2_mul(carry, t ? sh[t - 1] : e2_one());
    if (b < nb) {
      prods[2 * b] = excl.c0;
      prods[2 * b + 1] = excl.c1;
    }
    carry = e2_mul(carry, sh[SCAN_BLOCK - 1]);
    __syncthreads();
  }
}

// phase 3: z = the block's prefix times the exclusive prefix inside the
// block, then the partials over the ratios in the scratch columns
__global__ void __launch_bounds__(SCAN_BLOCK)
    finish(uint64_t* __restrict__ out, const uint64_t* __restrict__ prefix,
           long long n, int chunks, long long ldo) {
  __shared__ E2 sh[SCAN_BLOCK];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * SCAN_BLOCK + t;
  inclusive_scan(sh, row_total(out, i, n, ldo));
  if (i >= n) return;
  E2 z = t ? sh[t - 1] : e2_one();
  if (prefix)
    z = e2_mul(E2{prefix[2 * blockIdx.x], prefix[2 * blockIdx.x + 1]}, z);
  uint64_t* o = out + i * ldo;
  o[0] = z.c0;
  o[1] = z.c1;
  E2 part = z;
  for (int c = 0; c + 1 < chunks; ++c) {
    part = e2_mul(part, E2{o[2 + 2 * c], o[3 + 2 * c]});
    o[2 + 2 * c] = part.c0;
    o[3 + 2 * c] = part.c1;
  }
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
  const long long blocks = (p.n + ROW_THREADS - 1) / ROW_THREADS;
  rows_kernel<<<(unsigned)blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)wit, (const uint64_t*)setup, (const uint64_t*)x,
      (const uint64_t*)nonres, (const uint64_t*)scal, (const uint64_t*)sel,
      (uint64_t*)out, p);
  return (int)cudaGetLastError();
}

// out: the row kernel's output (n, ldo); prods: 2 * ceil(n / SCAN_BLOCK)
// values of scratch (null when n fits one block)
extern "C" int stage23_scan(void* out, void* prods, long long n, int chunks,
                            long long ldo, void* stream) {
  if (n <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (nb > 1) {
    if (!prods) return (int)cudaErrorInvalidValue;
    block_products<<<(unsigned)nb, SCAN_BLOCK, 0, s>>>(
        (const uint64_t*)out, (uint64_t*)prods, n, ldo);
    scan_products<<<1, SCAN_BLOCK, 0, s>>>((uint64_t*)prods, nb);
  }
  finish<<<(unsigned)nb, SCAN_BLOCK, 0, s>>>(
      (uint64_t*)out, nb > 1 ? (const uint64_t*)prods : nullptr, n, chunks,
      ldo);
  return (int)cudaGetLastError();
}
