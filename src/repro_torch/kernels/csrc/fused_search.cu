// Fused one-pass DB-LSH search kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference's serving path:
//   * fused_window_kernel (repro/kernels/window_verify.py:328, wrapper
//     repro/kernels/ops.py:281) -> fused_window_search_kernel below;
//   * fused_cand_kernel (repro/kernels/window_verify.py:374, wrapper
//     repro/kernels/ops.py:370) -> fused_cand_search_kernel below.
//
// What both compute (the oracle is repro/kernels/ref.py::fused_search_ref):
// for each query and each of its candidate slots, the window halfwidth
// hw = max_k |p_k - g_k|, the squared distance d2 (norm form
// max(||x||^2 - 2<q,x> + ||q||^2, 0) or diff form sum((x - q)^2)) and the
// schedule bin = #{j : hw > halves[j]}; then, per (query, bin j), the ks
// lexicographically smallest DISTINCT (d2, id) pairs with finite d2
// (unfilled: +inf / n) and cnt[q, j] = number of slots in bin j.
//
// Kernel B3, the reference's quantized modes of the same two kernels
// (`_slot_d2` modes bf16/int8, repro/kernels/window_verify.py:270, with
// the query quantized by repro/kernels/ops.py:262), is the kBf16 / kInt8
// instantiation of each: the dot runs on bf16 or int8 rows (x) against
// the quantized query, then is scaled by the slot's and the query's
// dequant scales; norms, q2 and admission stay float32.
//
// Bound on this card: the work is a gather of Q*S*B rows of K + d + 2
// words (31 MB at the main path, Q = 64, S = 25, B = 64, K = 10, d = 64:
// ~9 us at 3.35 TB/s), followed by a data-dependent selection.  At that
// size the kernel is bound by launch latency and by the selection, not
// by bandwidth.  The quantized rows are smaller (int8: K*4 + d + 12 =
// 116 bytes a slot, ~12 MB, ~3.5 us; bf16: 180 bytes, ~5.5 us), but the
// quantized search asks for ks = 4k per bin, four times the selection
// rounds of the float32 search: B3 is bound by its selection.
//
// Design (a simple, deterministic first version):
//   * one thread block per query, looping over the query's S*B slots —
//     the TPU grid's sequential revisits of one output block become a
//     loop inside the block, and no state crosses blocks;
//   * phase 1: each thread takes slots in a strided loop and computes
//     hw, bin and (for admitted slots) d2 in registers; the triples are
//     staged in shared memory;
//   * phase 2: warp w owns bins w, w + nwarps, ...; per bin it counts the
//     bin's slots, then runs ks rounds that each pick the smallest pair
//     strictly after the previous pick (a warp-wide lexicographic argmin
//     over shared memory).  "Strictly after" dedups identical pairs, and
//     ties on d2 resolve to the smallest id;
//   * no atomics: outputs are deterministic;
//   * a slot's d2 comes from one sequential fmaf chain over d that depends
//     only on (x, q), never on the slot's position, so the copies of one
//     point held by several tables give bit-identical (d2, id) pairs —
//     the dedup relies on that;
//   * block bases use 64-bit element offsets (the main path addresses
//     3.2e8 floats of vec_blocks);
//   * any d (no vector loads that would need d % 4 == 0; int8 rows are
//     read a byte at a time);
//   * the quantized query is staged in shared memory widened (bf16 to
//     float, int8 to int), in the place of the float32 query;
//   * the staging, hw, d2 and selection helpers live in search_common.cuh,
//     shared with the per-radius verify kernels (window_verify.cu).

#include "search_common.cuh"

namespace {

using namespace dblsh;

struct Stage {
  float* halves;  // (steps,)
  float* g;       // (L*K,) this query's projections
  float* q;       // (d,)
  float* d2;      // (C,) per-slot distances
  int* id;        // (C,) per-slot ids
  int* bin;       // (C,) per-slot bins (steps = never admitted)
};

__host__ __device__ inline size_t stage_bytes(int steps, int LK, int d, int C) {
  return sizeof(float) * (size_t)(steps + LK + d) +
         (size_t)C * (sizeof(float) + 2 * sizeof(int));
}

__device__ inline Stage carve(char* base, int steps, int LK, int d, int C) {
  Stage s;
  float* f = reinterpret_cast<float*>(base);
  s.halves = f;
  s.g = s.halves + steps;
  s.q = s.g + LK;
  s.d2 = s.q + d;
  s.id = reinterpret_cast<int*>(s.d2 + C);
  s.bin = s.id + C;
  return s;
}

// Stage this query's halves, projections and distance operand: the
// float32 query, or the quantized one widened (bf16 -> float, int8 -> int
// in the same 4-byte words).
template <int kMode>
__device__ inline void stage_query(const Stage& s, const float* __restrict__ halves,
                                   const float* __restrict__ g, const void* qv, int qi,
                                   int steps, int LK, int d) {
  stage(s.halves, halves, steps);
  stage(s.g, g + (int64_t)qi * LK, LK);
  if constexpr (kMode == kBf16) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(qv) + (int64_t)qi * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) s.q[i] = __bfloat162float(src[i]);
  } else if constexpr (kMode == kInt8) {
    const int8_t* src = static_cast<const int8_t*>(qv) + (int64_t)qi * d;
    int* dst = reinterpret_cast<int*>(s.q);
    for (int i = threadIdx.x; i < d; i += blockDim.x) dst[i] = src[i];
  } else {
    stage(s.q, static_cast<const float*>(qv) + (int64_t)qi * d, d);
  }
}

// d2 of slot `row` (a row of x and of the per-slot arrays) in mode kMode;
// xs: per-slot dequant scales (quantized modes only), qs: this query's.
template <int kMode>
__device__ inline float mode_d2(const void* x, int64_t row, const float* sq, int d,
                                float nrm, float q2, const float* __restrict__ xs,
                                float qs) {
  if constexpr (kMode == kExact) {
    return slot_d2<true>(static_cast<const float*>(x) + row * d, sq, d, nrm, q2);
  } else if constexpr (kMode == kNorm) {
    return slot_d2<false>(static_cast<const float*>(x) + row * d, sq, d, nrm, q2);
  } else if constexpr (kMode == kBf16) {
    return slot_d2_q(static_cast<const __nv_bfloat16*>(x) + row * d, sq, d, nrm, q2,
                     xs[row], qs);
  } else {
    return slot_d2_q(static_cast<const int8_t*>(x) + row * d,
                     reinterpret_cast<const int*>(sq), d, nrm, q2, xs[row], qs);
  }
}

__host__ __device__ constexpr bool quantized(int mode) { return mode == kBf16 || mode == kInt8; }

__device__ inline int slot_bin(float hw, const float* halves, int steps) {
  int b = 0;
  for (int j = 0; j < steps; ++j) b += hw > halves[j];
  return b;
}

// Phase 2: per-bin counts and distinct top-ks, one warp per bin.
__device__ void select_bins(const Stage& s, int C, int steps, int ks, int n,
                            float* __restrict__ bd, int* __restrict__ bi,
                            int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int* bin = s.bin;
  for (int j = threadIdx.x >> 5; j < steps; j += nwarps) {
    int in_bin = 0;
    for (int c = lane; c < C; c += 32) in_bin += bin[c] == j;
    for (int off = 16; off > 0; off >>= 1) in_bin += __shfl_xor_sync(kFullMask, in_bin, off);
    if (lane == 0) cnt[j] = in_bin;
    warp_select(s.d2, s.id, C, ks, n, [bin, j](int c) { return bin[c] == j; },
                bd + j * ks, bi + j * ks);
  }
}

// B1: slots are rows of the selected STR blocks of the flattened (L*nb)
// block axis; block ids outside [0, lnb) contribute nothing, not even to cnt.
// x: (L*nb, B, d) float32, bf16 or int8 by kMode; xs: (L*nb, B) dequant
// scales and qs: (Q,) query scales, read only in the quantized modes.
template <int kMode>
__global__ void __launch_bounds__(kThreads) fused_window_search_kernel(
    const int* __restrict__ blk, const float* __restrict__ halves,
    const float* __restrict__ proj, const void* __restrict__ x,
    const float* __restrict__ nrm, const int* __restrict__ ids,
    const float* __restrict__ g, const void* __restrict__ qv,
    const float* __restrict__ q2, const float* __restrict__ qs,
    const float* __restrict__ xs, float* __restrict__ bd, int* __restrict__ bi,
    int* __restrict__ cnt, int S, int M, int lnb, int B, int K, int d, int L,
    int steps, int ks, int n) {
  extern __shared__ __align__(16) char smem[];
  const int qi = blockIdx.x;
  const int C = S * B;
  const Stage s = carve(smem, steps, L * K, d, C);
  stage_query<kMode>(s, halves, g, qv, qi, steps, L * K, d);
  __syncthreads();

  const float qq = q2[qi];
  const float qsc = quantized(kMode) ? qs[qi] : 1.0f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int slot = c / B;
    const int b = c - slot * B;
    const int bk = blk[(int64_t)qi * S + slot];
    float dv = INFINITY;
    int iv = n;
    int bin = steps;
    if (bk >= 0 && bk < lnb) {
      const int64_t row = (int64_t)bk * B + b;
      bin = slot_bin(slot_hw(proj + row * K, s.g + (slot / M) * K, K), s.halves, steps);
      if (bin < steps) {
        dv = mode_d2<kMode>(x, row, s.q, d, nrm[row], qq, xs, qsc);
        iv = ids[row];
      }
    }
    s.d2[c] = dv;
    s.id[c] = iv;
    s.bin[c] = bin;
  }
  __syncthreads();
  select_bins(s, C, steps, ks, n, bd + (int64_t)qi * steps * ks,
              bi + (int64_t)qi * steps * ks, cnt + (int64_t)qi * steps);
}

// B2: slots are pre-gathered (Q, L, Ct, .) candidates; invalid slots carry
// +inf projections, so hw = +inf keeps them out of every bin.  cx is
// float32, bf16 or int8 by kMode; cscale: (Q, L, Ct) dequant scales.
template <int kMode>
__global__ void __launch_bounds__(kThreads) fused_cand_search_kernel(
    const float* __restrict__ cproj, const void* __restrict__ cx,
    const float* __restrict__ cnrm, const int* __restrict__ cids,
    const float* __restrict__ halves, const float* __restrict__ g,
    const void* __restrict__ qv, const float* __restrict__ q2,
    const float* __restrict__ qs, const float* __restrict__ cscale,
    float* __restrict__ bd, int* __restrict__ bi, int* __restrict__ cnt, int L,
    int Ct, int K, int d, int steps, int ks, int n) {
  extern __shared__ __align__(16) char smem[];
  const int qi = blockIdx.x;
  const int C = L * Ct;
  const Stage s = carve(smem, steps, L * K, d, C);
  stage_query<kMode>(s, halves, g, qv, qi, steps, L * K, d);
  __syncthreads();

  const float qq = q2[qi];
  const float qsc = quantized(kMode) ? qs[qi] : 1.0f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int64_t row = (int64_t)qi * C + c;
    float dv = INFINITY;
    int iv = n;
    const int bin = slot_bin(slot_hw(cproj + row * K, s.g + (c / Ct) * K, K), s.halves, steps);
    if (bin < steps) {
      dv = mode_d2<kMode>(cx, row, s.q, d, cnrm[row], qq, cscale, qsc);
      iv = cids[row];
    }
    s.d2[c] = dv;
    s.id[c] = iv;
    s.bin[c] = bin;
  }
  __syncthreads();
  select_bins(s, C, steps, ks, n, bd + (int64_t)qi * steps * ks,
              bi + (int64_t)qi * steps * ks, cnt + (int64_t)qi * steps);
}

// The instantiation of a kernel template for a wrapper's mode number.
template <typename Kernel>
Kernel pick(int mode, Kernel norm, Kernel exact, Kernel bf16, Kernel int8) {
  switch (mode) {
    case kNorm: return norm;
    case kExact: return exact;
    case kBf16: return bf16;
    case kInt8: return int8;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either kernel asks for (in every
// mode: the quantized query is staged widened to 4-byte words).
size_t fused_search_smem_bytes(int steps, int LK, int d, int C) {
  return stage_bytes(steps, LK, d, C);
}

const char* fused_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Returns a cudaError_t (0 = launched).  Launches on `stream`, no sync.
// mode: 0 norm, 1 exact (x, qv float32), 2 bf16, 3 int8 (x, qv in that
// type; qs and xs float32).  qs and xs are not read in modes 0 and 1.
int fused_window_search_launch(const int* blk, const float* halves, const float* proj,
                               const void* x, const float* nrm, const int* ids,
                               const float* g, const void* qv, const float* q2,
                               const float* qs, const float* xs, float* bd, int* bi,
                               int* cnt, int Q, int S, int M, int lnb, int B, int K, int d,
                               int L, int steps, int ks, int n, int mode,
                               cudaStream_t stream) {
  const size_t smem = stage_bytes(steps, L * K, d, S * B);
  auto kernel = pick(mode, fused_window_search_kernel<kNorm>,
                     fused_window_search_kernel<kExact>, fused_window_search_kernel<kBf16>,
                     fused_window_search_kernel<kInt8>);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<Q, kThreads, smem, stream>>>(blk, halves, proj, x, nrm, ids, g, qv, q2, qs, xs,
                                        bd, bi, cnt, S, M, lnb, B, K, d, L, steps, ks, n);
  return (int)cudaGetLastError();
}

int fused_cand_search_launch(const float* cproj, const void* cx, const float* cnrm,
                             const int* cids, const float* halves, const float* g,
                             const void* qv, const float* q2, const float* qs,
                             const float* cscale, float* bd, int* bi, int* cnt, int Q,
                             int L, int Ct, int K, int d, int steps, int ks, int n,
                             int mode, cudaStream_t stream) {
  const size_t smem = stage_bytes(steps, L * K, d, L * Ct);
  auto kernel = pick(mode, fused_cand_search_kernel<kNorm>, fused_cand_search_kernel<kExact>,
                     fused_cand_search_kernel<kBf16>, fused_cand_search_kernel<kInt8>);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<Q, kThreads, smem, stream>>>(cproj, cx, cnrm, cids, halves, g, qv, q2, qs,
                                        cscale, bd, bi, cnt, L, Ct, K, d, steps, ks, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
