// Per-radius verify kernels for Hopper (sm_90a): the engines of the
// multi-pass search (repro_torch.core.serve_search.search_batch_fixed_ref).
//
// Replaces the two Pallas TPU kernels of the reference's multi-pass path:
//   * window_verify_kernel (repro/kernels/window_verify.py:143, wrapper
//     repro/kernels/ops.py:94) -> window_verify_kernel below (B6, engine
//     'inline': reads the selected STR blocks of one table in place);
//   * candidate_verify_kernel (repro/kernels/window_verify.py:113, wrapper
//     repro/kernels/ops.py:46) -> candidate_verify_kernel below (B7, engine
//     'kernel': pre-gathered candidates, +inf projections on invalid slots).
//
// What both compute (twins: repro_torch/kernels/ref.py window_verify_ref,
// candidate_verify_ref): for each query, at one window width w, the box
// test max_k |p_k - g_k| <= 0.5f * w and id < n per candidate slot, the
// diff-form d2 = sum((x - q)^2) of the slots that pass, and the k
// lexicographically smallest DISTINCT (d2, id) pairs with finite d2,
// ascending; unfilled entries are (+inf, n).  That is the reference's
// merge_topk rule: smallest id on equal d2, identical pairs dropped.
//
// Bound on this card: a gather of the selected rows, K + d + 1 words per
// row (B6 reads each distinct selected block once: at most Q * M = 320
// blocks x 64 rows x 75 words, ~6 MB per call at the main path, Q = 64,
// M = 5, B = 64, K = 10, d = 64), plus g, q and the (Q, k) outputs: ~2 us
// at 3.35 TB/s.  The float32 work (3K + 2d per slot, ~3 Mflop) is far
// smaller, so bytes bound it; at these sizes the launch itself and one
// thread block per query on 64 of 132 SMs set the time.
//
// Design (a simple, deterministic first version, as B1/B2):
//   * one thread block per query; phase 1: each thread takes slots in a
//     strided loop, runs the box test and, for slots that pass, the d2
//     chain, and stages (d2, id) in shared memory;
//   * phase 2: warp 0 runs k rounds of a warp-wide lexicographic argmin,
//     each over the pairs strictly after the previous pick (warp_select);
//   * no atomics: outputs are deterministic;
//   * q is staged in shared memory and d2 is search_common.cuh's
//     slot_d2<true>, the chain B1/B2 use with exact=True, so the one-pass
//     search and this multi-pass oracle see bit-identical pairs;
//   * B6 reads block ids as plain int32 loads; an id outside [0, nb)
//     contributes nothing (the TPU kernel's route-to-block-0 has no
//     counterpart here);
//   * 64-bit element offsets, any d.

#include "search_common.cuh"

namespace {

using namespace dblsh;

struct VerifyStage {
  float* g;   // (K,) this query's projection in the table
  float* q;   // (d,)
  float* d2;  // (C,) per-slot distances (+inf outside the window)
  int* id;    // (C,) per-slot ids
};

__host__ __device__ inline size_t verify_stage_bytes(int K, int d, int C) {
  return sizeof(float) * (size_t)(K + d) + (size_t)C * (sizeof(float) + sizeof(int));
}

__device__ inline VerifyStage carve_verify(char* base, int K, int d, int C) {
  VerifyStage s;
  s.g = reinterpret_cast<float*>(base);
  s.q = s.g + K;
  s.d2 = s.q + d;
  s.id = reinterpret_cast<int*>(s.d2 + C);
  return s;
}

__device__ inline VerifyStage stage_verify(char* smem, const float* __restrict__ g,
                                           const float* __restrict__ q, int qi, int K,
                                           int d, int C) {
  const VerifyStage s = carve_verify(smem, K, d, C);
  stage(s.g, g + (int64_t)qi * K, K);
  stage(s.q, q + (int64_t)qi * d, d);
  return s;
}

__device__ inline void select_topk(const VerifyStage& s, int C, int k, int n,
                                   float* __restrict__ bd, int* __restrict__ bi) {
  if (threadIdx.x < 32)
    warp_select(s.d2, s.id, C, k, n, [](int) { return true; }, bd, bi);
}

// B6: slot c of query qi is row c % B of block blk[qi, c / B].
__global__ void __launch_bounds__(kThreads) window_verify_kernel(
    const int* __restrict__ blk, const float* __restrict__ proj,
    const float* __restrict__ x, const int* __restrict__ ids,
    const float* __restrict__ g, const float* __restrict__ q, float w,
    float* __restrict__ bd, int* __restrict__ bi, int M, int nb, int B, int K, int d,
    int k, int n) {
  extern __shared__ __align__(16) char smem[];
  const int qi = blockIdx.x;
  const int C = M * B;
  const VerifyStage s = stage_verify(smem, g, q, qi, K, d, C);
  __syncthreads();

  const float half = 0.5f * w;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int m = c / B;
    const int bk = blk[(int64_t)qi * M + m];
    float dv = INFINITY;
    int iv = n;
    if (bk >= 0 && bk < nb) {
      const int64_t row = (int64_t)bk * B + (c - m * B);
      iv = ids[row];
      if (iv < n && slot_hw(proj + row * K, s.g, K) <= half)
        dv = slot_d2<true>(x + row * d, s.q, d, 0.0f, 0.0f);
    }
    s.d2[c] = dv;
    s.id[c] = iv;
  }
  __syncthreads();
  select_topk(s, C, k, n, bd + (int64_t)qi * k, bi + (int64_t)qi * k);
}

// B7: slot c of query qi is row qi * C + c of the gathered candidates.
__global__ void __launch_bounds__(kThreads) candidate_verify_kernel(
    const float* __restrict__ cproj, const float* __restrict__ cx,
    const int* __restrict__ cids, const float* __restrict__ g,
    const float* __restrict__ q, float w, float* __restrict__ bd,
    int* __restrict__ bi, int C, int K, int d, int k, int n) {
  extern __shared__ __align__(16) char smem[];
  const int qi = blockIdx.x;
  const VerifyStage s = stage_verify(smem, g, q, qi, K, d, C);
  __syncthreads();

  const float half = 0.5f * w;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int64_t row = (int64_t)qi * C + c;
    const int iv = cids[row];
    float dv = INFINITY;
    if (iv < n && slot_hw(cproj + row * K, s.g, K) <= half)
      dv = slot_d2<true>(cx + row * d, s.q, d, 0.0f, 0.0f);
    s.d2[c] = dv;
    s.id[c] = iv;
  }
  __syncthreads();
  select_topk(s, C, k, n, bd + (int64_t)qi * k, bi + (int64_t)qi * k);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either verify kernel asks for.
size_t verify_smem_bytes(int K, int d, int C) { return verify_stage_bytes(K, d, C); }

// Returns a cudaError_t (0 = launched).  Launches on `stream`, no sync.
int window_verify_launch(const int* blk, const float* proj, const float* x, const int* ids,
                         const float* g, const float* q, float w, float* bd, int* bi,
                         int Q, int M, int nb, int B, int K, int d, int k, int n,
                         cudaStream_t stream) {
  const size_t smem = verify_stage_bytes(K, d, M * B);
  const int err = prepare(window_verify_kernel, smem);
  if (err != 0) return err;
  window_verify_kernel<<<Q, kThreads, smem, stream>>>(blk, proj, x, ids, g, q, w, bd, bi,
                                                      M, nb, B, K, d, k, n);
  return (int)cudaGetLastError();
}

int candidate_verify_launch(const float* cproj, const float* cx, const int* cids,
                            const float* g, const float* q, float w, float* bd, int* bi,
                            int Q, int C, int K, int d, int k, int n, cudaStream_t stream) {
  const size_t smem = verify_stage_bytes(K, d, C);
  const int err = prepare(candidate_verify_kernel, smem);
  if (err != 0) return err;
  candidate_verify_kernel<<<Q, kThreads, smem, stream>>>(cproj, cx, cids, g, q, w, bd, bi,
                                                         C, K, d, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
