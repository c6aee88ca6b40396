// The quotient sweep of a prove: every term of the quotient over the flat
// (qd·n) domain, α-weighted and summed, times the coset's 1/Z_H, written as
// the (qd·n, 2) quotient values the coset iNTT takes
// (boojum_tpu_torch/prover/quotient.py: the terms, their alphas' order, the
// plain version).
//
// Replaces the reference's one compiled program for the quotient,
// boojum_tpu/prover/device_prover.py:165 `_quotient_full_fn` (XLA fuses
// it; no Pallas kernel stands behind it): its lookup terms (:1844), gate
// sweeps (:1621) and copy-permutation terms (:1931) and the vanishing
// division. In eager torch the same work is about 88,000 launches of
// whole-column field ops a flagship prove, 520,000 a recursion outer prove.
//
// One entry, one launch: quotient_sweep. One thread a point of the flat
// domain, THREADS a block; a partial last block computes on its last point
// and stores nothing there. Every column is a row of an oracle's transposed
// flat LDE (k, L·n), read at the point: a warp's 32 reads are coalesced.
//
// - The lookup terms and the copy-permutation terms are fixed code over
//   the parameters: per repetition A·agg - 1 (or - sel), agg = β_l +
//   Σ γ^i·col_i (+ γ^width·id), then B·agg_t - m; the boundary (z - 1)·L1
//   and per chunk of qd copy columns lhs·Π(w + β·σ + γ) - rhs·Π(w +
//   (β·k_j)·x + γ), β·k_j made once a block in shared memory.
// - The alphas come as α alone (so that a prove with the device transcript
//   builds no power table in torch ops): every term, in the alphas' order
//   (the lookup terms, the tape's TERMs, whose alpha indices the wrapper
//   checks to run on without a gap, the copy-permutation terms), takes the
//   running power α^k of a register, which one ext product then moves to
//   α^(k + 1). A table of the powers in shared memory cost the recursion
//   outer prove's tape a block an SM of occupancy and 1.7x its time.
// - The gate terms are the circuit's recorded tape (cs/gates/tape.py), run
//   by an interpreter: the block stages the tape CHUNK instructions at a
//   time in shared memory, and every thread runs every instruction, so a
//   warp never diverges and each instruction is one broadcast read. The
//   tape's values live in its slots, in shared memory slot-major and
//   thread-minor (slot s of thread t at s·THREADS + t: a warp's 64-bit
//   accesses are conflict-free); an operand is a slot, a witness or setup
//   column (read from global memory at the point) or a constant of the
//   pool. TERM adds α·t into the gate's sum, FLUSH adds the gate's sum,
//   times its selector for a general gate, into the point's sum.
//
// The arithmetic is goldilocks.cuh's lazy family (any uint64_t in, a
// congruent uint64_t out) with ext products by Karatsuba; only the stored
// values are canonicalized, so the result is the plain version's bit for
// bit.
//
// Bound: the bytes. A flagship point reads about 266 u64 (93 witness, 105
// setup, 64 stage-2 columns, x, L1, z(ωx)) and writes 2: over 2^18 points
// 0.17 ms at 3.35 TB/s; its about 1,300 multiplies 0.08 ms at 4 INT32
// multiply-adds each (chip_smoke.py quotient_bound).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "ext2.cuh"
#include "goldilocks.cuh"

namespace {

using gl::affine;
using gl::E2;
using gl::e2_add;
using gl::e2_mul;
using gl::e2_scale;
using gl::e2_sub;
using gl::mul_add2;

constexpr int THREADS = 128;    // quotient.py THREADS
constexpr int CHUNK = 512;      // quotient.py CHUNK: instructions staged
constexpr int MAX_TID = 64;     // quotient.py MAX_TID
constexpr int MAX_DEVICES = 64;
// cs/gates/tape.py: opcodes and operand kinds (an operand's low two bits)
constexpr int OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_TERM = 3, OP_FLUSH = 4;
constexpr int SLOT = 0, WIT = 1, SETUP = 2;

// The host's int64 parameter array, in quotient.py `params` order.
constexpr int NUM_PARAMS = 21 + MAX_TID;
struct Params {
  long long n, ldw, lds, ld2;
  int log_n, qd, num_var, num_inter, lookup, specialized, nsub, pw, base_off,
      width, ntid, table_off, ntab, mult_col, ngpow, tape_len, slots;
  int tid[MAX_TID];
};

struct Args {
  const uint64_t *wit, *setup, *st2, *x, *l1, *zs, *sel, *vanish, *nonres,
      *scal;
  const int4* tape;
  const uint64_t* consts;
  uint64_t* out;
};

// acc + b * g for a base b and an ext g
__device__ __forceinline__ E2 add_scaled(E2 acc, uint64_t b, E2 g) {
  return E2{mul_add2(b, g.c0, acc.c0, 0), mul_add2(b, g.c1, acc.c1, 0)};
}

__device__ __forceinline__ E2 load_pair(const uint64_t* p) {
  return E2{__ldg(p), __ldg(p + 1)};
}

__global__ void __launch_bounds__(THREADS)
    quotient_kernel(const Args a, const Params p) {
  extern __shared__ uint64_t smem[];
  const int t = threadIdx.x;
  uint64_t* slot = smem + t;  // slot s of this thread at slot[s * THREADS]
  uint64_t* bk = smem + (size_t)p.slots * THREADS;  // β·k_j, (c0, c1) a j
  int4* code = reinterpret_cast<int4*>(bk + 2 * p.num_var);
  const long long size = (long long)p.qd << p.log_n;
  const long long i = (long long)blockIdx.x * THREADS + t;
  const long long pt = i < size ? i : size - 1;
  const uint64_t* scal = a.scal;
  const E2 beta = load_pair(scal), gamma = load_pair(scal + 2);
  // with lookups β_l at 4 and the γ powers from 6; then α
  const uint64_t* gpow = scal + 6;
  for (int j = t; j < p.num_var; j += THREADS) {
    const uint64_t k = __ldg(a.nonres + j);
    bk[2 * j] = gl::mul(beta.c0, k);
    bk[2 * j + 1] = gl::mul(beta.c1, k);
  }
  __syncthreads();  // β·k_j is written
  // α, and α^k of the next term in the alphas' order
  const E2 alpha = load_pair(scal + 4 + (p.lookup ? 2 + 2 * p.ngpow : 0));
  E2 apow{1, 0};
  const auto weigh = [&](E2 term) {
    const E2 r = e2_mul(term, apow);
    apow = e2_mul(apow, alpha);
    return r;
  };
  const auto wcol = [&](int c) {
    return __ldg(a.wit + (long long)c * p.ldw + pt);
  };
  const auto scol = [&](int c) {
    return __ldg(a.setup + (long long)c * p.lds + pt);
  };
  const auto s2pair = [&](int c) {
    return E2{__ldg(a.st2 + (long long)c * p.ld2 + pt),
              __ldg(a.st2 + (long long)(c + 1) * p.ld2 + pt)};
  };
  const int a_off = 2 * (1 + p.num_inter);
  E2 acc{0, 0};

  // lookups: A·agg - 1 (or - sel) a repetition, B·agg_t - m
  if (p.lookup) {
    const E2 lbeta = load_pair(scal + 4);
    const uint64_t one = p.specialized ? 1 : __ldg(a.sel + pt);
    for (int r = 0; r < p.nsub; ++r) {
      E2 agg = lbeta;
      const int base = p.base_off + r * p.pw;
      for (int c = 0; c < p.pw; ++c)
        agg = add_scaled(agg, wcol(base + c), load_pair(gpow + 2 * c));
      if (p.ntid)
        agg = add_scaled(agg, scol(p.tid[min(r, p.ntid - 1)]),
                         load_pair(gpow + 2 * p.width));
      E2 term = e2_mul(s2pair(a_off + 2 * r), agg);
      term.c0 = gl::sub_lazy(term.c0, one);
      acc = e2_add(acc, weigh(term));
    }
    E2 agg = lbeta;
    for (int c = 0; c < p.ntab; ++c)
      agg = add_scaled(agg, scol(p.table_off + c), load_pair(gpow + 2 * c));
    E2 term = e2_mul(s2pair(a_off + 2 * p.nsub), agg);
    term.c0 = gl::sub_lazy(term.c0, wcol(p.mult_col));
    acc = e2_add(acc, weigh(term));
  }

  // the gate terms: the tape, CHUNK instructions staged at a time
  const auto operand = [&](int v) -> uint64_t {
    const int idx = v >> 2;
    switch (v & 3) {
      case SLOT:
        return slot[idx * THREADS];
      case WIT:
        return wcol(idx);
      case SETUP:
        return scol(idx);
      default:
        return __ldg(a.consts + idx);
    }
  };
  E2 gacc{0, 0};
  for (int base = 0; base < p.tape_len; base += CHUNK) {
    const int count = min(CHUNK, p.tape_len - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = t; k < count; k += THREADS) code[k] = a.tape[base + k];
    __syncthreads();
    for (int k = 0; k < count; ++k) {
      const int4 ins = code[k];
      if (ins.x <= OP_MUL) {
        const uint64_t x = operand(ins.z), y = operand(ins.w);
        slot[ins.y * THREADS] = ins.x == OP_ADD   ? gl::add_lazy(x, y)
                                : ins.x == OP_SUB ? gl::sub_lazy(x, y)
                                                  : gl::mul_lazy(x, y);
      } else if (ins.x == OP_TERM) {
        gacc = add_scaled(gacc, operand(ins.z), apow);
        apow = e2_mul(apow, alpha);
      } else if (ins.x == OP_FLUSH) {
        if (ins.y) gacc = e2_scale(gacc, operand(ins.z));
        acc = e2_add(acc, gacc);
        gacc = E2{0, 0};
      }
    }
  }

  // the copy permutation: the boundary, then one relation a chunk
  const E2 z = s2pair(0);
  const uint64_t x = __ldg(a.x + pt);
  const E2 zm1{gl::sub_lazy(z.c0, 1), z.c1};
  acc = e2_add(acc, weigh(e2_scale(zm1, __ldg(a.l1 + pt))));
  for (int rel = 0; rel <= p.num_inter; ++rel) {
    E2 lhs = rel < p.num_inter ? s2pair(2 + 2 * rel)
                               : load_pair(a.zs + 2 * pt);
    E2 rhs = rel == 0 ? z : s2pair(2 * rel);
    const int end = min(rel * p.qd + p.qd, p.num_var);
    for (int j = rel * p.qd; j < end; ++j) {
      const uint64_t w = wcol(j), s = scol(j);
      lhs = e2_mul(lhs, affine(w, s, beta, gamma));
      rhs = e2_mul(rhs, affine(w, x, E2{bk[2 * j], bk[2 * j + 1]}, gamma));
    }
    acc = e2_add(acc, weigh(e2_sub(lhs, rhs)));
  }

  // divide by the vanishing poly: 1/Z_H is one value a coset
  acc = e2_scale(acc, __ldg(a.vanish + (pt >> p.log_n)));
  if (i < size)
    *reinterpret_cast<ulonglong2*>(a.out + 2 * i) = make_ulonglong2(
        gl::canonicalize(acc.c0), gl::canonicalize(acc.c1));
}

// Lets the kernel take ``bytes`` of dynamic shared memory on the current
// device: the attribute is set once a device for the largest size asked
// (above the 48 KB every kernel may take).
cudaError_t allow_shared(size_t bytes) {
  static size_t granted[MAX_DEVICES] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < MAX_DEVICES && granted[dev] >= bytes) return cudaSuccess;
  rc = cudaFuncSetAttribute(quotient_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)bytes);
  if (rc == cudaSuccess && dev < MAX_DEVICES) granted[dev] = bytes;
  return rc;
}

}  // namespace

// params: quotient.py `params` (NUM_PARAMS int64 values, read before the
// call returns); sel may be null in the specialized lookup modes and
// without lookups, tape and consts for an empty tape
extern "C" int quotient_sweep(const void* wit, const void* setup,
                              const void* st2, const void* x, const void* l1,
                              const void* zs, const void* sel,
                              const void* vanish, const void* nonres,
                              const void* scal, const void* tape,
                              const void* consts, void* out,
                              const long long* params, void* stream) {
  const long long* q = params;
  Params p;
  p.n = q[0];
  p.log_n = (int)q[1];
  p.qd = (int)q[2];
  p.ldw = q[3];
  p.lds = q[4];
  p.ld2 = q[5];
  int* fields[] = {&p.num_var, &p.num_inter, &p.lookup,   &p.specialized,
                   &p.nsub,    &p.pw,        &p.base_off, &p.width,
                   &p.ntid,    &p.table_off, &p.ntab,     &p.mult_col,
                   &p.ngpow,   &p.tape_len,  &p.slots};
  static_assert(NUM_PARAMS == 6 + 15 + MAX_TID, "parameter count");
  for (int k = 0; k < 15; ++k) *fields[k] = (int)q[6 + k];
  for (int k = 0; k < MAX_TID; ++k) p.tid[k] = (int)q[21 + k];
  if (p.n <= 0 || (p.n & (p.n - 1)) || (1LL << p.log_n) != p.n ||
      p.qd <= 0 || p.num_var <= 0 || p.slots < 0 ||
      p.ntid < 0 || p.ntid > MAX_TID || p.tape_len < 0 ||
      (p.tape_len && !tape) || (p.lookup && !p.specialized && !sel))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint64_t) *
                          ((size_t)p.slots * THREADS + 2 * (size_t)p.num_var) +
                      sizeof(int4) * CHUNK;
  const cudaError_t rc = allow_shared(smem);
  if (rc != cudaSuccess) return (int)rc;
  const Args a{(const uint64_t*)wit,    (const uint64_t*)setup,
               (const uint64_t*)st2,    (const uint64_t*)x,
               (const uint64_t*)l1,     (const uint64_t*)zs,
               (const uint64_t*)sel,    (const uint64_t*)vanish,
               (const uint64_t*)nonres, (const uint64_t*)scal,
               (const int4*)tape,       (const uint64_t*)consts,
               (uint64_t*)out};
  const long long blocks = ((long long)p.qd * p.n + THREADS - 1) / THREADS;
  quotient_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      a, p);
  return (int)cudaGetLastError();
}
