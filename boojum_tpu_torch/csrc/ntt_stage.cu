// ntt_stage: one radix-R NTT stage (R = 128 or 256) along axis 0 of an
// (R, M) Goldilocks column batch, with an optional fused cross twiddle.
//
// Replaces the TPU kernel boojum_tpu/ntt/mxu_ntt.py:_mxu_kernel_v2 (and its
// v1 twin _mxu_kernel, which computes the same function at twmode 0). The
// TPU kernel expands each element into byte digits to feed the f32 matrix
// unit; Hopper multiplies 64-bit integers natively, so this kernel runs the
// log2(R) radix-2 butterfly stages of ntt_cols / intt_cols instead:
//   forward  (INVERSE = false): natural rows in, bitreversed rows out (DIF);
//   inverse  (INVERSE = true):  bitreversed rows in, natural rows out (DIT),
//                               times 1/R;
//   TWMODE 1: out[r, l] *= tw[r, l & (W - 1)]  (the forward four-step pass)
//   TWMODE 2: in[r, l]  *= tw[r, l & (W - 1)]  (the inverse four-step pass)
// with W a power of two. Outputs are canonical, so they are bit-identical to
// the TPU kernel's.
//
// Bound: bytes. Each element is read once and written once (16 bytes)
// against log2(R)/2 butterfly multiplies.
//
// Design. With G = R/16, row i = h*G + q (h < 16, q < G). The first four
// DIF stages pair rows G*8, G*4, G*2, G apart, so they stay inside the 16
// rows {h*G + q : h < 16} of one q; the remaining log2(R) - 4 stages pair
// rows at most 8 apart, so they stay inside the 16 rows {16*q + i : i < 16}.
// A thread owns one q and two adjacent columns: it loads its 16 rows of each
// column with one 16-byte load per row, runs the first four stages on them in
// registers, writes them to shared memory, and after one __syncthreads()
// reads back the 16 rows 16q .. 16q + 15, runs the remaining stages in
// registers (two 8-point transforms at R = 128) and stores. The inverse runs
// the same two halves mirrored (DIT stages in reverse order). So there are
// two __syncthreads() per tile: one after the R/2 stage twiddles are copied
// into shared memory, one for the exchange. The shared memory holds the
// exchange only: R x TILE elements, 32 KB at both radices (TILE = 16 columns
// at R = 256, 32 at R = 128), so shared memory would let six blocks share an
// SM; the registers (32 elements a thread, 146-168 registers) hold it to
// three. Every index is a compile-time constant or a shift and mask of the
// thread's (q, c); the only runtime multiply is the row pitch, once per tile.
// Butterflies run on lazy representatives (goldilocks.cuh) with one
// canonicalization per element, at the store; butterflies whose twiddle is 1
// skip the multiply. What bounds the kernel in practice is its integer
// instructions (about 190 an element, about half of them in the lazy adds and
// subtractions), not its bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;  // 3 x 128 threads per SM: up to 168 registers

template <int LOG_R>
struct Shape {
  static constexpr int R = 1 << LOG_R;
  static constexpr int G = R / 16;             // threads per column pair
  static constexpr int PAIRS = THREADS / G;    // column pairs per block
  static constexpr int TILE = 2 * PAIRS;       // columns per block
};

// Loads columns (col, col + 1) of one row; vec: both are in range and the
// pair is 16-byte aligned.
__device__ __forceinline__ void load_pair(const uint64_t* __restrict__ p,
                                          bool vec, int valid, uint64_t& a,
                                          uint64_t& b) {
  if (vec) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
    a = v.x;
    b = v.y;
  } else {
    a = valid > 0 ? p[0] : 0;
    b = valid > 1 ? p[1] : 0;
  }
}

__device__ __forceinline__ void store_pair(uint64_t* __restrict__ p, bool vec,
                                           int valid, uint64_t a, uint64_t b) {
  if (vec) {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(a, b);
  } else {
    if (valid > 0) p[0] = a;
    if (valid > 1) p[1] = b;
  }
}

// Forward radix-2 DIF butterfly on lazy values: (u + v, (u - v) * w).
__device__ __forceinline__ void dif(uint64_t& u, uint64_t& v, uint64_t w) {
  const uint64_t d = gl::sub_lazy(u, v);
  u = gl::add_lazy(u, v);
  v = gl::mul_lazy(d, w);
}

// Inverse radix-2 DIT butterfly on lazy values: (u + v*w, u - v*w).
__device__ __forceinline__ void dit(uint64_t& u, uint64_t& v, uint64_t w) {
  const uint64_t t = gl::mul_lazy(v, w);
  v = gl::sub_lazy(u, t);
  u = gl::add_lazy(u, t);
}

// The four stages whose pairs lie in the strided rows h*G + q: stage k
// pairs h with h + (8 >> k) and uses w^(((h mod (8 >> k)) * G + q) << k).
template <int LOG_R, bool INVERSE>
__device__ __forceinline__ void strided_stages(uint64_t (&a)[16],
                                               uint64_t (&b)[16],
                                               const uint64_t* tws, int q) {
  constexpr int G = Shape<LOG_R>::G;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = INVERSE ? 3 - s : s;
    const int span = 8 >> k;
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      if (h & span) continue;
      const uint64_t w = tws[(((h & (span - 1)) * G) + q) << k];
      if (INVERSE) {
        dit(a[h], a[h + span], w);
        dit(b[h], b[h + span], w);
      } else {
        dif(a[h], a[h + span], w);
        dif(b[h], b[h + span], w);
      }
    }
  }
}

// The stages 4 .. LOG_R - 1, whose pairs lie in the 16 consecutive rows
// 16q + i: stage k pairs i with i + half (half = R >> (k + 1) <= 8) and uses
// w^((i mod half) << k), a compile-time index (w^0 = 1 skips the multiply).
template <int LOG_R, bool INVERSE>
__device__ __forceinline__ void local_stages(uint64_t (&a)[16],
                                             uint64_t (&b)[16],
                                             const uint64_t* tws) {
  constexpr int R = Shape<LOG_R>::R;
#pragma unroll
  for (int s = 0; s < LOG_R - 4; ++s) {
    const int k = INVERSE ? LOG_R - 1 - s : 4 + s;
    const int half = R >> (k + 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i & half) continue;
      const int j = i & (half - 1);
      if (j == 0) {  // w^0 = 1: DIF and DIT both give (u + v, u - v)
        const uint64_t u = a[i], v = a[i + half];
        a[i] = gl::add_lazy(u, v);
        a[i + half] = gl::sub_lazy(u, v);
        const uint64_t x = b[i], y = b[i + half];
        b[i] = gl::add_lazy(x, y);
        b[i + half] = gl::sub_lazy(x, y);
        continue;
      }
      const uint64_t w = tws[j << k];
      if (INVERSE) {
        dit(a[i], a[i + half], w);
        dit(b[i], b[i + half], w);
      } else {
        dif(a[i], a[i + half], w);
        dif(b[i], b[i + half], w);
      }
    }
  }
}

// x, y: (R, m) row-major; tw_stage: the R/2 powers w^j of the stage root (its
// inverse when INVERSE); tw: (R, tw_width) cross twiddles, tw_width a power
// of two; scale: 1/R for the inverse.
template <int LOG_R, bool INVERSE, int TWMODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ntt_stage_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                 const uint64_t* __restrict__ tw_stage,
                 const uint64_t* __restrict__ tw, long long m,
                 long long tw_width, uint64_t scale, int vec_ok) {
  using S = Shape<LOG_R>;
  constexpr int R = S::R, G = S::G, PAIRS = S::PAIRS, TILE = S::TILE;
  __shared__ uint64_t tws[R / 2];
  __shared__ __align__(16) uint64_t ex[R * TILE];  // the exchange, (R, TILE)

  for (int j = threadIdx.x; j < R / 2; j += THREADS) tws[j] = tw_stage[j];

  const int c = threadIdx.x % PAIRS;  // column pair inside the tile
  const int q = threadIdx.x / PAIRS;  // row class
  const long long col = (long long)blockIdx.x * TILE + 2 * c;
  const int valid = (int)(m - col < 2 ? (m - col > 0 ? m - col : 0) : 2);
  const bool vec = vec_ok && valid == 2;
  const long long tw_mask = tw_width - 1;
  const long long tw_col0 = col & tw_mask, tw_col1 = (col + 1) & tw_mask;

  // Row h of the first half is first_in + h * STEP_IN, of the second half
  // first_out + h * STEP_OUT: the strided rows h*G + q start at q with step
  // G, the local rows 16q + h at 16q with step 1. Forward runs strided then
  // local, inverse local then strided.
  constexpr int STEP_IN = INVERSE ? 1 : G, STEP_OUT = INVERSE ? G : 1;
  const int first_in = INVERSE ? 16 * q : q;
  const int first_out = INVERSE ? q : 16 * q;

  uint64_t a[16], b[16];
  {
    const uint64_t* xp = x + first_in * m + col;
    const uint64_t* tp = tw + first_in * tw_width;
    const long long x_step = STEP_IN * m, tw_step = STEP_IN * tw_width;
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      load_pair(xp + h * x_step, vec, valid, a[h], b[h]);
      if (TWMODE == 2) {
        a[h] = gl::mul_lazy(a[h], tp[h * tw_step + tw_col0]);
        b[h] = gl::mul_lazy(b[h], tp[h * tw_step + tw_col1]);
      }
    }
  }
  __syncthreads();  // tws ready

  if (INVERSE) {
    local_stages<LOG_R, true>(a, b, tws);
  } else {
    strided_stages<LOG_R, false>(a, b, tws, q);
  }

#pragma unroll
  for (int h = 0; h < 16; ++h)
    *reinterpret_cast<ulonglong2*>(&ex[(first_in + h * STEP_IN) * TILE + 2 * c]) =
        make_ulonglong2(a[h], b[h]);
  __syncthreads();  // the exchange
#pragma unroll
  for (int h = 0; h < 16; ++h) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(
        &ex[(first_out + h * STEP_OUT) * TILE + 2 * c]);
    a[h] = v.x;
    b[h] = v.y;
  }

  if (INVERSE) {
    strided_stages<LOG_R, true>(a, b, tws, q);
  } else {
    local_stages<LOG_R, false>(a, b, tws);
  }

  uint64_t* yp = y + first_out * m + col;
  const uint64_t* tp = tw + first_out * tw_width;
  const long long y_step = STEP_OUT * m, tw_step = STEP_OUT * tw_width;
#pragma unroll
  for (int h = 0; h < 16; ++h) {
    uint64_t u = a[h], v = b[h];
    if (INVERSE) {
      u = gl::mul_lazy(u, scale);
      v = gl::mul_lazy(v, scale);
    }
    if (TWMODE == 1) {
      u = gl::mul_lazy(u, tp[h * tw_step + tw_col0]);
      v = gl::mul_lazy(v, tp[h * tw_step + tw_col1]);
    }
    store_pair(yp + h * y_step, vec, valid, gl::canonicalize(u),
               gl::canonicalize(v));
  }
}

template <int LOG_R, bool INVERSE, int TWMODE>
cudaError_t launch(const uint64_t* x, uint64_t* y, const uint64_t* tw_stage,
                   const uint64_t* tw, long long m, long long tw_width,
                   uint64_t scale, int vec_ok, cudaStream_t stream) {
  constexpr int TILE = Shape<LOG_R>::TILE;
  const unsigned grid = (unsigned)((m + TILE - 1) / TILE);
  ntt_stage_kernel<LOG_R, INVERSE, TWMODE><<<grid, THREADS, 0, stream>>>(
      x, y, tw_stage, tw, m, tw_width, scale, vec_ok);
  return cudaGetLastError();
}

template <int LOG_R, bool INVERSE>
cudaError_t launch_tw(int twmode, const uint64_t* x, uint64_t* y,
                      const uint64_t* tw_stage, const uint64_t* tw,
                      long long m, long long tw_width, uint64_t scale,
                      int vec_ok, cudaStream_t stream) {
  switch (twmode) {
    case 0:
      return launch<LOG_R, INVERSE, 0>(x, y, tw_stage, tw, m, tw_width, scale,
                                       vec_ok, stream);
    case 1:
      return launch<LOG_R, INVERSE, 1>(x, y, tw_stage, tw, m, tw_width, scale,
                                       vec_ok, stream);
    case 2:
      return launch<LOG_R, INVERSE, 2>(x, y, tw_stage, tw, m, tw_width, scale,
                                       vec_ok, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (R, m) row-major, R = 2^log_r with log_r 7 or 8; tw: (R, tw_width)
// with tw_width a power of two (unread at twmode 0).
extern "C" int ntt_stage(const void* x, void* y, const void* tw_stage,
                         const void* tw, int log_r, long long m, int inverse,
                         int twmode, long long tw_width,
                         unsigned long long scale, void* stream) {
  if ((log_r != 7 && log_r != 8) || m <= 0 || twmode < 0 || twmode > 2 ||
      tw_width <= 0 || (tw_width & (tw_width - 1)))
    return (int)cudaErrorInvalidValue;
  const int vec_ok = m % 2 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)y % 16 == 0;
  const auto* xs = (const uint64_t*)x;
  auto* ys = (uint64_t*)y;
  const auto* ts = (const uint64_t*)tw_stage;
  const auto* tc = (const uint64_t*)tw;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (log_r == 8)
    err = inverse ? launch_tw<8, true>(twmode, xs, ys, ts, tc, m, tw_width,
                                       scale, vec_ok, st)
                  : launch_tw<8, false>(twmode, xs, ys, ts, tc, m, tw_width,
                                        scale, vec_ok, st);
  else
    err = inverse ? launch_tw<7, true>(twmode, xs, ys, ts, tc, m, tw_width,
                                       scale, vec_ok, st)
                  : launch_tw<7, false>(twmode, xs, ys, ts, tc, m, tw_width,
                                        scale, vec_ok, st);
  return (int)err;
}
