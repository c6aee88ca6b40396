// ntt_small: every radix-2 stage of an n-point NTT (n = 2^log_n <= 4096)
// along axis 0 of an (n, B) Goldilocks column batch, in one pass over
// device memory.
//
// Replaces the TPU kernel boojum_tpu/ntt/pallas_ntt.py:_kernel_body, which
// holds an (n, 128) column block in VMEM and runs all log n stages there:
//   forward (inverse = 0): natural rows in, bitreversed rows out (DIF);
//   inverse (inverse = 1): bitreversed rows in, natural rows out, the stages
//                          in reverse order, times n^-1.
// The twiddles of stage k are entries [n - (n >> k), n - (n >> (k + 1))) of
// the concatenated table of pallas_ntt._stage_tables_host. Outputs are
// canonical, so they are bit-identical to the TPU kernel's.
//
// Bound: bytes. Each element is read once and written once (16 bytes)
// against log2(n)/2 butterfly multiplies, which the card's integer rate
// covers up to n = 4096.
//
// Design: one block per tile of T columns, the (n, T) tile in dynamic shared
// memory. T depends on n so that the tile fills 64 KB (n = 8: T = 1024;
// n = 512: T = 16), at least 4 columns (n = 4096: 128 KB), and no wider than
// the batch needs. Loads and stores walk the tile row by row, neighbouring
// threads on neighbouring columns, so a row of T columns is one contiguous
// run of 8T bytes in device memory. All stages run in place in shared memory
// with one __syncthreads() between stages; index arithmetic is shifts and
// masks only. Offsets into device memory are 64-bit (one call may hold 2^27
// elements and more).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LOG_N = 12;
constexpr int TILE_LOG_ELEMS = 13;  // 2^13 u64 = 64 KB of shared memory
constexpr int MIN_LOG_T = 2;

__global__ void __launch_bounds__(THREADS)
ntt_small_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                 const uint64_t* __restrict__ tw, int log_n, int log_t,
                 long long b, int inverse, uint64_t n_inv) {
  extern __shared__ uint64_t s[];  // (n, T) row-major
  const int n = 1 << log_n;
  const int t_mask = (1 << log_t) - 1;
  const int elems = n << log_t;
  const long long col0 = (long long)blockIdx.x << log_t;
  const int cols = (int)(b - col0 < (1 << log_t) ? b - col0 : (1 << log_t));

#pragma unroll 4
  for (int e = threadIdx.x; e < elems; e += THREADS) {
    const int row = e >> log_t, c = e & t_mask;
    s[e] = c < cols ? x[(long long)row * b + col0 + c] : 0;
  }
  __syncthreads();

  const int pairs = elems >> 1;
  for (int step = 0; step < log_n; ++step) {
    const int k = inverse ? log_n - 1 - step : step;
    const int log_half = log_n - 1 - k;  // half = n >> (k + 1)
    const uint64_t* w = tw + (n - (n >> k));
    for (int e = threadIdx.x; e < pairs; e += THREADS) {
      const int c = e & t_mask, p = e >> log_t;
      const int j = p & ((1 << log_half) - 1);
      const int iu = ((((p >> log_half) << (log_half + 1)) + j) << log_t) + c;
      const int iv = iu + (1 << (log_half + log_t));
      if (!inverse) {
        const uint64_t u = s[iu], v = s[iv];
        s[iu] = gl::add(u, v);
        s[iv] = gl::mul(gl::sub(u, v), w[j]);
      } else {
        const uint64_t a = s[iu];
        const uint64_t t = gl::mul(s[iv], w[j]);
        s[iu] = gl::add(a, t);
        s[iv] = gl::sub(a, t);
      }
    }
    __syncthreads();
  }

#pragma unroll 4
  for (int e = threadIdx.x; e < elems; e += THREADS) {
    const int row = e >> log_t, c = e & t_mask;
    if (c < cols) {
      const uint64_t v = s[e];
      y[(long long)row * b + col0 + c] = inverse ? gl::mul(v, n_inv) : v;
    }
  }
}

}  // namespace

// x, y: (2^log_n, b) u64 row-major, distinct buffers; tw: the stage table of
// 2^log_n entries; n_inv: n^-1 mod p (read when inverse = 1).
extern "C" int ntt_small(const void* x, void* y, const void* tw, int log_n,
                         long long b, int inverse, unsigned long long n_inv,
                         void* stream) {
  if (log_n < 0 || log_n > MAX_LOG_N || b <= 0)
    return (int)cudaErrorInvalidValue;
  int log_t = TILE_LOG_ELEMS - log_n;
  if (log_t < MIN_LOG_T) log_t = MIN_LOG_T;
  int log_b = 0;  // ceil(log2(b))
  while ((1LL << log_b) < b) ++log_b;
  if (log_t > log_b) log_t = log_b;
  const long long grid = (b + (1LL << log_t) - 1) >> log_t;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint64_t) << (log_n + log_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt_small_kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw, log_n, log_t, b,
      inverse, (uint64_t)n_inv);
  return (int)cudaGetLastError();
}
