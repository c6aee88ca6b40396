// ntt_small: every radix-2 stage of an n-point NTT (n = 2^L, L <= 12) along
// axis 0 of an (n, B) Goldilocks column batch, in one pass over device
// memory, with an optional cross twiddle multiplied in at the store.
//
// Replaces the TPU kernel boojum_tpu/ntt/pallas_ntt.py:_kernel_body, which
// holds an (n, 128) column block in VMEM and runs all log n stages there:
//   forward (INV = false): natural rows in, bitreversed rows out (DIF);
//   inverse (INV = true):  bitreversed rows in, natural rows out, the stages
//                          in reverse order (DIT), times n^-1;
//   EPI (forward only):    out[r, c] *= tt[r, c >> tt_shift], tt of shape
//                          (n, B >> tt_shift): the four-step cross twiddle,
//                          which the TPU path multiplies in a separate pass.
// Stage k (pairs n >> (k + 1) rows apart) uses entries [n - (n >> k),
// n - (n >> (k + 1))) of the concatenated table of
// pallas_ntt._stage_tables_host. Outputs are canonical, so they are
// bit-identical to the TPU kernel's.
//
// Bound. Each element is read once and written once (16 bytes), plus the
// cross-twiddle table: at (8, 2^24) with the (8, 2^21) table, 2.28 GB, 0.68
// ms at 3.35 TB/s; at (512, 2^18), 2.15 GB, 0.64 ms. n = 8 (3 stages, all
// by shifts, and the epilogue's one multiply) is bound by bytes. n = 512
// needs 9 butterfly stages an element, and each lazy add, subtract and
// multiply is 8 to 20 integer instructions, so there the kernel is bound by
// integer issue: at the card's issue rate the 2^27 elements of (512, 2^18)
// would meet the byte bound only below about 80 instructions an element.
//
// Design. A thread holds 2^A rows of each of its 2 adjacent columns in
// registers, A = min(L, 3): 16 elements, so a thread fits in 64 registers
// and an SM holds 1024 threads to hide the latency of loads, exchanges and
// stores. Writing a row index in bits, stage k pairs rows that differ in bit
// L - 1 - k; the stages split into phases of A bits, the lowest phase
// holding bits [0, A), the next [A, 2A), and so on. In a phase a thread
// holds the 2^A rows that differ in bits [c, c + A), its thread index giving
// the other bits (c = min(lowest bit of the phase, L - A)), and runs the
// phase's stages in registers. Between phases the column tile goes once
// through shared memory (a __syncthreads() each way), so L <= 3 is a pure
// stream with no shared memory or barrier, and n = 512 has two exchanges.
// Stages whose twiddle index is known at compile time (the phase with
// c = 0, stages of at most 8 points) multiply by shifts: every 64th root of
// unity is a power of two (omega_64 = 2^39 mod p, 2^96 = -1), so the twiddle
// omega_m^j is 2^e with e < 192 and its sign folds into the butterfly's add
// and subtract. The other stages read their twiddles from the stage table in
// shared memory. (Holding 2^5 rows of one column, the stages of up to 32
// points multiply by shifts, but the 32 elements need 128 registers and run
// 13 % slower at n = 512: measured.) n^-1 = 2^(192 - L) is a shift too.
// Butterflies run on lazy representatives (goldilocks.cuh) with one
// canonicalization per element at the store, after the cross twiddle, which
// a single-phase thread loads together with its data and a block whose
// columns share one table column stages in shared memory. A block covers a
// 64 KB column tile (16 columns at n = 512) or, for L <= 3, 512 columns;
// loads and stores are 16 bytes a thread, neighbouring threads on
// neighbouring columns; offsets into device memory are 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_LOG_N = 12;

template <int L>
struct Shape {
  static constexpr int N = 1 << L;
  static constexpr int C = 2;              // columns a thread holds
  static constexpr int A = L < 3 ? L : 3;  // rows a thread holds: 2^A
  static constexpr int H = 1 << A;
  static constexpr int P = L == 0 ? 1 : (L + A - 1) / A;  // phases
  static constexpr int G = 1 << (L - A);  // threads per column pair
  // columns per block: 256 threads for a single phase, else an (N, TILE)
  // tile of 64 KB (512 threads)
  static constexpr int TILE = P == 1 ? 512 : 1 << (13 - L);
  static constexpr int LANES = TILE / C;  // threads along a row
  static constexpr int THREADS = LANES * G;
  static constexpr bool TABLE = P > 1;  // general stages read shared memory
  // shared memory: the stage table, the exchange tile, and one column of
  // cross twiddles (the epilogue's, when a block's columns share it)
  static constexpr size_t SMEM =
      TABLE ? sizeof(uint64_t) * ((size_t)N * (2 + TILE)) : 0;

  // phase ph covers row bits [lo, hi]; its thread holds bits [held, held + A)
  __host__ __device__ static constexpr int lo(int ph) {
    return A * (P - 1 - ph);
  }
  __host__ __device__ static constexpr int hi(int ph) {
    return lo(ph) + A - 1 < L - 1 ? lo(ph) + A - 1 : L - 1;
  }
  __host__ __device__ static constexpr int held(int ph) {
    return lo(ph) < L - A ? lo(ph) : L - A;
  }
};

// omega_(2^(bit+1)) = 2^E for bit <= 5 (omega_64 = 2^39)
__host__ __device__ constexpr int root_exp(int bit) {
  return (39 << (5 - bit)) % 192;
}

// Row of element h of thread q in a phase whose held bits start at co.
template <int L>
__device__ __forceinline__ int row_of(int q, int h, int co) {
  constexpr int A = Shape<L>::A;
  return (q & ((1 << co) - 1)) | (h << co) | ((q >> co) << (co + A));
}

// Forward DIF butterfly on lazy values: (u + v, (u - v) * w).
__device__ __forceinline__ void dif(uint64_t& u, uint64_t& v, uint64_t w) {
  const uint64_t d = gl::sub_lazy(u, v);
  u = gl::add_lazy(u, v);
  v = gl::mul_lazy(d, w);
}

// (u + v, (u - v) * 2^e), the sign of 2^e = -2^(e - 96) folded into the
// subtraction.
__device__ __forceinline__ void dif_pow2(uint64_t& u, uint64_t& v, int e) {
  const uint64_t d = e < 96 ? gl::sub_lazy(u, v) : gl::sub_lazy(v, u);
  u = gl::add_lazy(u, v);
  v = gl::mul_pow2_96(d, e < 96 ? e : e - 96);
}

// Inverse DIT butterfly on lazy values: (u + v*w, u - v*w).
__device__ __forceinline__ void dit(uint64_t& u, uint64_t& v, uint64_t w) {
  const uint64_t t = gl::mul_lazy(v, w);
  v = gl::sub_lazy(u, t);
  u = gl::add_lazy(u, t);
}

// (u + v * 2^e, u - v * 2^e), the sign folded as in dif_pow2.
__device__ __forceinline__ void dit_pow2(uint64_t& u, uint64_t& v, int e) {
  const uint64_t t = gl::mul_pow2_96(v, e < 96 ? e : e - 96);
  const uint64_t a = gl::add_lazy(u, t), s = gl::sub_lazy(u, t);
  u = e < 96 ? a : s;
  v = e < 96 ? s : a;
}

// The stages of phase PH on the registers of thread q: forward from the
// phase's highest bit down, inverse from its lowest bit up.
template <int L, bool INV, int PH>
__device__ __forceinline__ void phase_stages(
    uint64_t (&v)[Shape<L>::C][Shape<L>::H], int q, const uint64_t* tws) {
  using S = Shape<L>;
  constexpr int LO = S::lo(PH), HI = S::hi(PH), CO = S::held(PH);
  const int j_lo = q & ((1 << CO) - 1);  // twiddle index bits from q
#pragma unroll
  for (int s = 0; s <= HI - LO; ++s) {
    const int bit = INV ? LO + s : HI - s;
    const int d = bit - CO;
#pragma unroll
    for (int h = 0; h < S::H; ++h) {
      if (h & (1 << d)) continue;
      const int hp = h + (1 << d);
      const int jh = (h & ((1 << d) - 1)) << CO;
      if (bit == 0 || (CO == 0 && bit <= 5)) {
        // j = jh < 2^bit is a compile-time constant: w = 2^e
        const int f = (root_exp(bit) * jh) % 192;
        const int e = INV ? (192 - f) % 192 : f;
#pragma unroll
        for (int c = 0; c < S::C; ++c) {
          if (INV)
            dit_pow2(v[c][h], v[c][hp], e);
          else
            dif_pow2(v[c][h], v[c][hp], e);
        }
      } else {
        const uint64_t w = tws[S::N - (2 << bit) + (j_lo | jh)];
#pragma unroll
        for (int c = 0; c < S::C; ++c) {
          if (INV)
            dit(v[c][h], v[c][hp], w);
          else
            dif(v[c][h], v[c][hp], w);
        }
      }
    }
  }
}

// Hands the tile from the rows of phase FROM to those of phase TO through
// shared memory, laid out (N, TILE) row-major.
template <int L, int FROM, int TO>
__device__ __forceinline__ void exchange(
    uint64_t (&v)[Shape<L>::C][Shape<L>::H], uint64_t* ex, int q, int lane) {
  using S = Shape<L>;
#pragma unroll
  for (int h = 0; h < S::H; ++h) {
    uint64_t* p = ex + row_of<L>(q, h, S::held(FROM)) * S::TILE + lane * S::C;
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0][h], v[1][h]);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < S::H; ++h) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(
        ex + row_of<L>(q, h, S::held(TO)) * S::TILE + lane * S::C);
    v[0][h] = w.x;
    v[1][h] = w.y;
  }
}

// Phases in order (forward 0 .. P-1, inverse P-1 .. 0), an exchange between
// each two; a barrier before every exchange after the first keeps a thread
// from overwriting rows that another has not read yet.
template <int L, bool INV, int STEP>
__device__ __forceinline__ void run_phases(
    uint64_t (&v)[Shape<L>::C][Shape<L>::H], const uint64_t* tws,
    uint64_t* ex, int q, int lane) {
  using S = Shape<L>;
  if constexpr (STEP < S::P) {
    constexpr int PH = INV ? S::P - 1 - STEP : STEP;
    if constexpr (STEP > 0) {
      if constexpr (STEP > 1) __syncthreads();
      exchange<L, INV ? PH + 1 : PH - 1, PH>(v, ex, q, lane);
    }
    phase_stages<L, INV, PH>(v, q, tws);
    run_phases<L, INV, STEP + 1>(v, tws, ex, q, lane);
  }
}

// Where the store finds its cross twiddles: nowhere (no epilogue), the
// thread's registers, the block's column in shared memory, or device memory.
enum TwSource { TW_NONE, TW_REGS, TW_SHARED, TW_GLOBAL };

// The store of the last phase: times n^-1 (inverse) or the cross twiddle
// (forward), then one canonicalization; 16-byte stores where vec. Element h
// is row row0 + h * 2^held, yp points at row row0 of the thread's columns,
// and for TW_GLOBAL tg at the table entry of row 0 for the thread's first
// column; its second column reads the next entry when tt_shift = 0
// (tt_cols = b), else the same one.
template <int L, bool INV, int SRC>
__device__ __forceinline__ void store(
    const uint64_t (&v)[Shape<L>::C][Shape<L>::H], uint64_t* yp, long long b,
    bool vec, int valid, int row0,
    const uint64_t (&tv)[Shape<L>::C][Shape<L>::H], const uint64_t* tts,
    const uint64_t* tg, long long tt_cols) {
  using S = Shape<L>;
  constexpr int C = S::C, HELD = S::held(INV ? 0 : S::P - 1);
  const long long step = b << HELD;
#pragma unroll
  for (int h = 0; h < S::H; ++h, yp += step) {
    const int row = row0 + (h << HELD);
    uint64_t o[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint64_t u = v[c][h];
      if (INV) u = gl::mul_pow2(u, (192 - L) % 192);  // n^-1 = 2^(192 - L)
      if (SRC == TW_REGS) u = gl::mul_lazy(u, tv[c][h]);
      if (SRC == TW_SHARED) u = gl::mul_lazy(u, tts[row]);
      if (SRC == TW_GLOBAL && c < valid)
        u = gl::mul_lazy(u, __ldg(tg + (long long)row * tt_cols +
                                  (c > 0 && tt_cols == b ? 1 : 0)));
      o[c] = gl::canonicalize(u);
    }
    if (vec) {
      *reinterpret_cast<ulonglong2*>(yp) = make_ulonglong2(o[0], o[1]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < valid) yp[c] = o[c];
    }
  }
}

// x, y: (N, b) row-major, distinct buffers; tw: the stage table (N entries,
// inverse roots for INV); tt: the cross twiddles, (N, b >> tt_shift)
// (read when EPI); vec_ok: b even and x, y 16-byte aligned.
// Two blocks an SM: at most 128 registers a thread in the 256-thread
// blocks of a single phase, 64 in the 512-thread blocks of several phases
// (16 elements fit without spilling, and 1024 threads an SM hide the
// latency of the loads, exchanges and stores).
template <int L, bool INV, bool EPI>
__global__ void __launch_bounds__(Shape<L>::THREADS, 2)
ntt_small_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                 const uint64_t* __restrict__ tw,
                 const uint64_t* __restrict__ tt, long long b, int tt_shift,
                 int vec_ok) {
  using S = Shape<L>;
  constexpr int C = S::C, H = S::H;
  constexpr int FIRST = INV ? S::P - 1 : 0, LAST = INV ? 0 : S::P - 1;
  extern __shared__ __align__(16) uint64_t smem[];
  uint64_t* tws = smem;                       // the stage table, N entries
  uint64_t* ex = smem + S::N;                 // the exchange tile, (N, TILE)
  uint64_t* tts = ex + S::N * S::TILE;        // the block's cross twiddles
  const long long col0 = (long long)blockIdx.x * S::TILE;
  const long long tt_cols = b >> tt_shift;
  // every column of the block reads the same table column: stage it
  const bool tt_staged = EPI && S::TABLE && ((S::TILE - 1) >> tt_shift) == 0;
  if (S::TABLE) {
    for (int j = threadIdx.x; j < S::N; j += S::THREADS) {
      tws[j] = tw[j];
      if (tt_staged) tts[j] = __ldg(tt + j * tt_cols + (col0 >> tt_shift));
    }
  }

  const int lane = threadIdx.x % S::LANES, q = threadIdx.x / S::LANES;
  const long long col = col0 + lane * C;
  const long long left = b - col;
  const int valid = left <= 0 ? 0 : (left < C ? (int)left : C);
  const bool vec = vec_ok && valid == 2;

  // element h of a phase lies 2^held * h rows after element 0
  uint64_t v[C][H];
  {
    const uint64_t* p = x + row_of<L>(q, 0, S::held(FIRST)) * b + col;
    const long long step = b << S::held(FIRST);
    if (vec) {
#pragma unroll
      for (int h = 0; h < H; ++h, p += step) {
        const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p);
        v[0][h] = w.x;
        v[1][h] = w.y;
      }
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h, p += step)
#pragma unroll
        for (int c = 0; c < C; ++c) v[c][h] = c < valid ? p[c] : 0;
    }
  }
  // one phase: the cross twiddles of the thread's rows are loaded with its
  // data, so their latency overlaps the loads instead of following the
  // stages (two columns share a table column when tt_shift > 0)
  constexpr bool TV = S::P == 1 && EPI;
  uint64_t tv[C][H];  // unused (and so dropped) unless TV
  if constexpr (TV) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint64_t* t = tt + row_of<L>(q, h, 0) * tt_cols;
#pragma unroll
      for (int c = 0; c < C; ++c)
        tv[c][h] = c >= valid ? 0
                   : c > 0 && tt_shift > 0 ? tv[0][h]
                                           : __ldg(t + ((col + c) >> tt_shift));
    }
  }
  if (S::TABLE) __syncthreads();  // the stage table is in

  run_phases<L, INV, 0>(v, tws, ex, q, lane);

  // the store; the branch on where the cross twiddles are is uniform
  const int row0 = row_of<L>(q, 0, S::held(LAST));
  uint64_t* yp = y + row0 * b + col;
  if constexpr (!EPI) {
    store<L, INV, TW_NONE>(v, yp, b, vec, valid, row0, tv, tts, tt, 0);
  } else if constexpr (TV) {
    store<L, INV, TW_REGS>(v, yp, b, vec, valid, row0, tv, tts, tt, 0);
  } else if (tt_staged) {
    store<L, INV, TW_SHARED>(v, yp, b, vec, valid, row0, tv, tts, tt, 0);
  } else {
    store<L, INV, TW_GLOBAL>(v, yp, b, vec, valid, row0, tv, tts,
                             tt + (col >> tt_shift), tt_cols);
  }
}

template <int L, bool INV, bool EPI>
cudaError_t launch(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                   const uint64_t* tt, long long b, int tt_shift, int vec_ok,
                   cudaStream_t stream) {
  using S = Shape<L>;
  const long long grid = (b + S::TILE - 1) / S::TILE;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_small_kernel<L, INV, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (err != cudaSuccess) return err;
  }
  ntt_small_kernel<L, INV, EPI><<<(unsigned)grid, S::THREADS, S::SMEM,
                                  stream>>>(x, y, tw, tt, b, tt_shift, vec_ok);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(int, const uint64_t*, uint64_t*,
                                 const uint64_t*, const uint64_t*, long long,
                                 int, int, cudaStream_t);

// mode 0: forward, 1: forward with the cross twiddle, 2: inverse
template <int L>
cudaError_t launch_mode(int mode, const uint64_t* x, uint64_t* y,
                        const uint64_t* tw, const uint64_t* tt, long long b,
                        int tt_shift, int vec_ok, cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch<L, false, false>(x, y, tw, tt, b, tt_shift, vec_ok, stream);
    case 1:
      return launch<L, false, true>(x, y, tw, tt, b, tt_shift, vec_ok, stream);
    default:
      return launch<L, true, false>(x, y, tw, tt, b, tt_shift, vec_ok, stream);
  }
}

constexpr LaunchFn LAUNCH[MAX_LOG_N + 1] = {
    launch_mode<0>, launch_mode<1>, launch_mode<2>,  launch_mode<3>,
    launch_mode<4>, launch_mode<5>, launch_mode<6>,  launch_mode<7>,
    launch_mode<8>, launch_mode<9>, launch_mode<10>, launch_mode<11>,
    launch_mode<12>};

}  // namespace

// x, y: (2^log_n, b) u64 row-major, distinct buffers; tw: the stage table of
// 2^log_n entries (inverse roots when inverse = 1); tt: null, or the forward
// cross twiddles, (2^log_n, b >> tt_shift) row-major, with b a multiple of
// 2^tt_shift.
extern "C" int ntt_small(const void* x, void* y, const void* tw,
                         const void* tt, int log_n, long long b, int inverse,
                         int tt_shift, void* stream) {
  if (log_n < 0 || log_n > MAX_LOG_N || b <= 0 || tt_shift < 0 ||
      tt_shift > 62 || (tt && (inverse || b % (1LL << tt_shift))))
    return (int)cudaErrorInvalidValue;
  const int vec_ok = b % 2 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)y % 16 == 0;
  const int mode = inverse ? 2 : (tt ? 1 : 0);
  return (int)LAUNCH[log_n](mode, (const uint64_t*)x, (uint64_t*)y,
                            (const uint64_t*)tw, (const uint64_t*)tt, b,
                            tt ? tt_shift : 0, vec_ok, (cudaStream_t)stream);
}
