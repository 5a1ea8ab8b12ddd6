// Per-slot distance and window halfwidth kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference's pool engines:
//   * window_dist_kernel (repro/kernels/window_verify.py:217, wrapper
//     repro/kernels/ops.py:205) -> window_dist_kernel below (B4);
//   * candidate_dist_kernel (repro/kernels/window_verify.py:189, wrapper
//     repro/kernels/ops.py:149) -> candidate_dist_kernel below (B5).
//
// What both compute: for each query and each of its candidate slots, the
// window halfwidth hw = max_k |p_k - g_k| against the slot's table's query
// projection, and the squared distance d2 (norm form max(||x||^2 - 2<q,x>
// + ||q||^2, 0), or diff form sum((x - q)^2)) into a flat (Q, C) pool,
// C = L*M*B (B4) or L*Ct (B5), table-major.  No window mask, no top-k: the
// caller applies the radius schedule to hw.  B4 reads the selected STR
// blocks of the flattened (L*nb) block axis in place and writes +inf to
// both outputs on every slot of an invalid block (id outside [0, L*nb)),
// in both forms; B5 reads pre-gathered candidates, where a +inf
// projection gives hw = +inf and a +inf norm d2 = +inf in norm form.
//
// Bound on this card: bytes.  Each slot reads K + d + 1 words and writes
// 2; at the main path (Q = 64, S = 25, B = 64, K = 10, d = 64) that is
// ~31 MB read and 0.8 MB written, ~9.4 us at 3.35 TB/s, against 2 MFLOP
// per query of arithmetic.
//
// Design (simple first version, the arithmetic of the fused kernels):
//   * B4: one thread block per (query, slot), its threads over the B rows
//     of the slot's block; B5: one thread block per (query, table, 64
//     slots).  The block stages its query's g (its table's K words) and q
//     in shared memory;
//   * hw and d2 come from the header's slot_hw and slot_d2<kExact> on the
//     same q2 that the fused kernels' wrappers pass, so the pool, binned,
//     is bit-equal to B1's (B4) and B2's (B5) bins;
//   * block ids are plain int32 loads; an invalid one writes +inf, and no
//     row is read for it (the TPU's route-to-block-0 trick has no use);
//   * 64-bit row and output offsets (the main path addresses 3.2e8 floats
//     of vec_blocks).

#include "search_common.cuh"

namespace {

using namespace dblsh;

constexpr int kDistThreads = 64;

template <bool kExact>
__global__ void __launch_bounds__(kDistThreads) window_dist_kernel(
    const int* __restrict__ blk, const float* __restrict__ proj,
    const float* __restrict__ vec, const float* __restrict__ nrm,
    const float* __restrict__ g, const float* __restrict__ q,
    const float* __restrict__ q2, float* __restrict__ d2_out,
    float* __restrict__ hw_out, int S, int M, int lnb, int B, int K, int d, int L) {
  extern __shared__ __align__(16) float dist_smem[];
  const int64_t qs = blockIdx.x;  // qi * S + s
  const int qi = (int)(qs / S);
  const int s = (int)(qs - (int64_t)qi * S);
  const int64_t out = qs * B;
  const int bk = blk[qs];
  if (bk < 0 || bk >= lnb) {  // block-uniform: no thread stages anything
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      d2_out[out + b] = INFINITY;
      hw_out[out + b] = INFINITY;
    }
    return;
  }
  float* sg = dist_smem;
  float* sq = sg + K;
  stage(sg, g + ((int64_t)qi * L + s / M) * K, K);
  stage(sq, q + (int64_t)qi * d, d);
  __syncthreads();
  const float qq = q2[qi];
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int64_t row = (int64_t)bk * B + b;
    hw_out[out + b] = slot_hw(proj + row * K, sg, K);
    d2_out[out + b] = slot_d2<kExact>(vec + row * d, sq, d, nrm[row], qq);
  }
}

template <bool kExact>
__global__ void __launch_bounds__(kDistThreads) candidate_dist_kernel(
    const float* __restrict__ cproj, const float* __restrict__ cvec,
    const float* __restrict__ cnrm, const float* __restrict__ g,
    const float* __restrict__ q, const float* __restrict__ q2,
    float* __restrict__ d2_out, float* __restrict__ hw_out, int L, int Ct, int K, int d) {
  extern __shared__ __align__(16) float dist_smem[];
  const int64_t ql = blockIdx.x;  // qi * L + l
  const int qi = (int)(ql / L);
  float* sg = dist_smem;
  float* sq = sg + K;
  stage(sg, g + ql * K, K);
  stage(sq, q + (int64_t)qi * d, d);
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= Ct) return;
  const int64_t row = ql * Ct + c;  // also the output slot
  hw_out[row] = slot_hw(cproj + row * K, sg, K);
  d2_out[row] = slot_d2<kExact>(cvec + row * d, sq, d, cnrm[row], q2[qi]);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of either kernel: g (K) and q (d).
size_t dist_smem_bytes(int K, int d) { return sizeof(float) * (size_t)(K + d); }

// Return a cudaError_t (0 = launched).  Launch on `stream`, no sync.
// q2: (Q,) squared norms of the queries (read in norm form only).
int window_dist_launch(const int* blk, const float* proj, const float* vec,
                       const float* nrm, const float* g, const float* q, const float* q2,
                       float* d2, float* hw, int Q, int S, int M, int lnb, int B, int K,
                       int d, int L, int exact, cudaStream_t stream) {
  const size_t smem = dist_smem_bytes(K, d);
  auto kernel = exact ? window_dist_kernel<true> : window_dist_kernel<false>;
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  const unsigned grid = (unsigned)((int64_t)Q * S);
  kernel<<<grid, kDistThreads, smem, stream>>>(blk, proj, vec, nrm, g, q, q2, d2, hw, S, M,
                                               lnb, B, K, d, L);
  return (int)cudaGetLastError();
}

int candidate_dist_launch(const float* cproj, const float* cvec, const float* cnrm,
                          const float* g, const float* q, const float* q2, float* d2,
                          float* hw, int Q, int L, int Ct, int K, int d, int exact,
                          cudaStream_t stream) {
  const size_t smem = dist_smem_bytes(K, d);
  auto kernel = exact ? candidate_dist_kernel<true> : candidate_dist_kernel<false>;
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)((int64_t)Q * L), (Ct + kDistThreads - 1) / kDistThreads);
  kernel<<<grid, kDistThreads, smem, stream>>>(cproj, cvec, cnrm, g, q, q2, d2, hw, L, Ct,
                                               K, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
