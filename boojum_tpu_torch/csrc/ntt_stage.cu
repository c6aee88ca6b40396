// ntt_stage: one radix-R NTT stage (R = 128 or 256) along axis 0 of an
// (R, M) Goldilocks column batch, with an optional fused cross twiddle.
//
// Replaces the TPU kernel boojum_tpu/ntt/mxu_ntt.py:_mxu_kernel_v2 (and its
// v1 twin _mxu_kernel, which computes the same function at twmode 0). The
// TPU kernel expands each element into byte digits to feed the f32 matrix
// unit; Hopper multiplies 64-bit integers natively, so this kernel runs the
// log2(R) radix-2 butterfly stages of ntt_cols / intt_cols instead:
//   forward  (inverse = 0): natural rows in, bitreversed rows out;
//   inverse  (inverse = 1): bitreversed rows in, natural rows out, times 1/R.
//   twmode 1: out[r, l] *= tw[r, l % W]  (the forward four-step pass)
//   twmode 2: in[r, l]  *= tw[r, l % W]  (the inverse four-step pass)
// Outputs are canonical, so they are bit-identical to the TPU kernel's.
//
// Design: one block per tile of TILE columns. The (R, TILE) tile is loaded
// into shared memory with coalesced rows (R = 256: 64 KB, dynamic shared
// memory), every butterfly stage works in place there with __syncthreads()
// between stages, and the tile is stored once. So device memory sees each
// input read once and each output written once: the stage is bound by
// bytes (16 bytes per element against log2(R)/2 butterfly multiplies).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

// tw_stage: the R/2 powers w^j of the stage root (w = omega_R, or its
// inverse when inverse = 1); stage k uses w^(j * 2^k).
__global__ void __launch_bounds__(THREADS)
ntt_stage_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                 const uint64_t* __restrict__ tw_stage,
                 const uint64_t* __restrict__ tw, int log_r, long long m,
                 int inverse, int twmode, long long tw_width,
                 uint64_t scale) {
  extern __shared__ uint64_t s[];  // (R, TILE) row-major
  const int r = 1 << log_r;
  const long long col0 = (long long)blockIdx.x * TILE;
  const int cols = (int)((m - col0) < TILE ? (m - col0) : TILE);

  for (int e = threadIdx.x; e < r * TILE; e += THREADS) {
    const int row = e / TILE, c = e % TILE;
    uint64_t v = 0;
    if (c < cols) {
      const long long col = col0 + c;
      v = x[(long long)row * m + col];
      if (twmode == 2) v = gl::mul(v, tw[(long long)row * tw_width + col % tw_width]);
    }
    s[e] = v;
  }
  __syncthreads();

  const int pairs = (r / 2) * TILE;
  if (!inverse) {
    for (int k = 0; k < log_r; ++k) {
      const int half = r >> (k + 1);
      for (int e = threadIdx.x; e < pairs; e += THREADS) {
        const int c = e % TILE, p = e / TILE;
        const int blk = p / half, j = p % half;
        const int iu = (blk * 2 * half + j) * TILE + c;
        const int iv = iu + half * TILE;
        const uint64_t u = s[iu], v = s[iv];
        s[iu] = gl::add(u, v);
        s[iv] = gl::mul(gl::sub(u, v), tw_stage[j << k]);
      }
      __syncthreads();
    }
  } else {
    for (int k = log_r - 1; k >= 0; --k) {
      const int half = r >> (k + 1);
      for (int e = threadIdx.x; e < pairs; e += THREADS) {
        const int c = e % TILE, p = e / TILE;
        const int blk = p / half, j = p % half;
        const int iu = (blk * 2 * half + j) * TILE + c;
        const int iv = iu + half * TILE;
        const uint64_t a = s[iu];
        const uint64_t t = gl::mul(s[iv], tw_stage[j << k]);
        s[iu] = gl::add(a, t);
        s[iv] = gl::sub(a, t);
      }
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < r * TILE; e += THREADS) {
    const int row = e / TILE, c = e % TILE;
    if (c >= cols) continue;
    const long long col = col0 + c;
    uint64_t v = s[e];
    if (inverse) v = gl::mul(v, scale);
    if (twmode == 1) v = gl::mul(v, tw[(long long)row * tw_width + col % tw_width]);
    y[(long long)row * m + col] = v;
  }
}

}  // namespace

extern "C" int ntt_stage(const void* x, void* y, const void* tw_stage,
                         const void* tw, int log_r, long long m, int inverse,
                         int twmode, long long tw_width,
                         unsigned long long scale, void* stream) {
  if (log_r < 1 || log_r > 8 || m <= 0) return (int)cudaErrorInvalidValue;
  const int r = 1 << log_r;
  const size_t smem = (size_t)r * TILE * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((m + TILE - 1) / TILE);
  ntt_stage_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)y, (const uint64_t*)tw_stage,
      (const uint64_t*)tw, log_r, m, inverse, twmode, tw_width,
      (uint64_t)scale);
  return (int)cudaGetLastError();
}
