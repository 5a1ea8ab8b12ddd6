// Device helpers shared by the fused one-pass kernels (fused_search.cu,
// B1/B2) and the per-radius verify kernels (window_verify.cu, B6/B7).
//
// One copy of each helper is what makes the one-pass search with
// exact=True bit-equal to the multi-pass oracle inside the port: both
// paths stage q in shared memory with `stage`, compute a slot's diff-form
// d2 with the same `slot_d2<true>` fmaf chain, and select by the same
// rule (the distinct lexicographic top-k of `warp_select`), so one point
// yields the same (d2, id) pair in every kernel.  B1/B2 (and B3, their
// quantized modes) read their rows from shared memory, where they stage
// them, run the same chains there (fused_search.cu's staged_d2, with
// dequant_d2 below for B3) and select by sorting each bin's pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace dblsh {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// Block-wide copy of `count` floats to shared memory (strided by thread).
__device__ inline void stage(float* dst, const float* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Window halfwidth of one slot: max_k |p_k - g_k| (p in global memory,
// g staged).  A slot is inside the window of half width h iff hw <= h.
__device__ inline float slot_hw(const float* __restrict__ p, const float* g, int K) {
  float hw = 0.0f;
  for (int k = 0; k < K; ++k) hw = fmaxf(hw, fabsf(__ldg(p + k) - g[k]));
  return hw;
}

// Squared distance of one slot: one sequential fmaf chain over d that
// depends only on (x, q), never on the slot's position, so every copy of
// a point gives a bit-identical d2.  kExact: diff form sum((x - q)^2);
// else the norm form max(nrm - 2<q,x> + q2, 0).
template <bool kExact>
__device__ inline float slot_d2(const float* __restrict__ x, const float* q, int d,
                                float nrm, float q2) {
  float acc = 0.0f;
  if constexpr (kExact) {
    for (int i = 0; i < d; ++i) {
      const float t = __ldg(x + i) - q[i];
      acc = fmaf(t, t, acc);
    }
    return acc;
  } else {
    for (int i = 0; i < d; ++i) acc = fmaf(__ldg(x + i), q[i], acc);
    return fmaxf(nrm - 2.0f * acc + q2, 0.0f);
  }
}

// The distance modes of the fused kernels, numbered as the wrappers'
// `_MODES`: the float32 norm and diff forms, and kernel B3's quantized dots.
enum Mode : int { kNorm = 0, kExact = 1, kBf16 = 2, kInt8 = 3 };

// Dequantize a quantized dot and finish the norm form, in the reference's
// order: t = (xs * qs) * dot, then max(nrm - 2 t + q2, 0).  Every step is
// an explicitly rounded intrinsic, so nothing is contracted into an fma
// and the result is bit-equal to the plain PyTorch twin for the same dot.
__device__ inline float dequant_d2(float dot, float nrm, float q2, float xs, float qs) {
  const float t = __fmul_rn(__fmul_rn(xs, qs), dot);
  return fmaxf(__fadd_rn(__fsub_rn(nrm, __fmul_rn(2.0f, t)), q2), 0.0f);
}

// Lexicographic (d, id) "a < b".
__device__ inline bool pair_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Run by one whole warp: write the ks lexicographically smallest DISTINCT
// (d2, id) pairs with finite d2 among the staged slots c < C for which
// keep(c) holds, ascending, to bd/bi; unfilled entries get (+inf, fill).
// Each round is a warp-wide argmin over the pairs strictly after the
// previous pick: "strictly after" drops identical pairs (the dedup), and
// equal d2 resolve to the smallest id — the reference's merge_topk rule.
template <typename Keep>
__device__ void warp_select(const float* d2, const int* id, int C, int ks, int fill,
                            Keep keep, float* __restrict__ bd, int* __restrict__ bi) {
  const int lane = threadIdx.x & 31;
  float last_d = -INFINITY;
  int last_i = INT_MIN;
  int r = 0;
  for (; r < ks; ++r) {
    float best_d = INFINITY;
    int best_i = INT_MAX;
    for (int c = lane; c < C; c += 32) {
      if (!keep(c)) continue;
      const float dv = d2[c];
      const int iv = id[c];
      if (pair_less(last_d, last_i, dv, iv) && pair_less(dv, iv, best_d, best_i)) {
        best_d = dv;
        best_i = iv;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFullMask, best_d, off);
      const int oi = __shfl_xor_sync(kFullMask, best_i, off);
      if (pair_less(od, oi, best_d, best_i)) {
        best_d = od;
        best_i = oi;
      }
    }
    if (!(best_d < INFINITY)) break;  // warp-uniform: every lane holds the min
    if (lane == 0) {
      bd[r] = best_d;
      bi[r] = best_i;
    }
    last_d = best_d;
    last_i = best_i;
  }
  for (int rr = r + lane; rr < ks; rr += 32) {
    bd[rr] = INFINITY;
    bi[rr] = fill;
  }
}

// Raise a kernel's dynamic shared memory limit to `smem` bytes.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace dblsh
