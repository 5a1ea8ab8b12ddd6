// Squared-L2 distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pairwise_l2_kernel
// (repro/kernels/pairwise_l2.py:25, wrapper repro/kernels/ops.py:444):
// D2[i, j] = max(||Q_i||^2 - 2 Q_i.X_j + ||X_j||^2, 0), (nq, nn) float32,
// for float32 or bf16 inputs.  The TPU kernel runs the product on the MXU
// with float32 accumulation; here a bf16 input is widened to float on load,
// and a bf16 x bf16 product is exact in float32, so float32 FMAs compute
// what the bf16 dot with float32 accumulation computes, up to the order of
// the sum.  Products are plain float32 FMAs, never TF32.
//
// Bound on this card: bytes at a small batch, operations at a large one.
// Against n = 1M points of d = 64, Q = 64 queries read 256 MB of X and
// write a 256 MB matrix (0.153 ms at 3.35 TB/s) for 8.6 GFLOP (0.128 ms
// at 67 TFLOP/s float32); Q = 1024 writes 4.1 GB (1.30 ms) for 131 GFLOP
// (1.96 ms).  Tensor cores (wgmma on bf16, TMA) are a later redesign.
//
// Design (a plain tiled kernel):
//   * one 256-thread block per 64 x 64 output tile, a 4 x 4 register
//     micro-tile per thread (rows ty + 16 i, columns tx + 16 j, so that the
//     tile's stores are 16 consecutive floats of a row);
//   * d streamed through shared-memory tiles of 32, stored transposed and
//     padded by one word (k-major, stride 65: the staging stores and the
//     micro-tile's loads are free of bank conflicts);
//   * ||q||^2 and ||x||^2 accumulated from the same staged tiles, by the
//     first two warps (rows) and the next two (columns), as the TPU kernel
//     adds its norms per d-tile; the clamp at 0 is applied once, at the end;
//   * ragged edges in every dimension masked in the kernel (zeros staged,
//     stores skipped), no padded copies; 64-bit row and output offsets
//     (nq * nn passes 2^31 at Q >= 2148 against n = 1M).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;   // output tile edge
constexpr int kTileD = 32;  // d per shared-memory tile
constexpr int kStride = kTile + 1;
constexpr int kSide = 16;   // threads per tile edge; each owns 4 x 4 outputs
constexpr int kMicro = kTile / kSide;
constexpr int kL2Threads = kSide * kSide;

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage rows [row0, row0 + 64) x columns [k0, k0 + 32) of a row-major
// (rows, d) matrix into sh[k * kStride + r], widened, zero outside the
// matrix.  Lane = k: a warp reads 32 consecutive elements of one row.
template <typename T>
__device__ inline void stage_tile(float* sh, const T* __restrict__ src, int64_t row0, int rows,
                                  int k0, int d) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + lane;
  for (int r = threadIdx.x >> 5; r < kTile; r += kL2Threads / 32) {
    const int64_t row = row0 + r;
    sh[lane * kStride + r] = (row < rows && k < d) ? widen(src[row * d + k]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kL2Threads) pairwise_l2_kernel(
    const T* __restrict__ q, const T* __restrict__ x, float* __restrict__ out, int nq, int nn,
    int d) {
  __shared__ float qs[kTileD * kStride];
  __shared__ float xs[kTileD * kStride];
  __shared__ float qn[kTile];
  __shared__ float xn[kTile];
  const int64_t row0 = (int64_t)blockIdx.y * kTile;  // rows of Q, of the output
  const int64_t col0 = (int64_t)blockIdx.x * kTile;  // rows of X, columns of the output
  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  float acc[kMicro][kMicro] = {};
  float norm = 0.0f;  // t < 64: ||Q_{row0+t}||^2; 64 <= t < 128: ||X_{col0+t-64}||^2
  for (int k0 = 0; k0 < d; k0 += kTileD) {
    stage_tile(qs, q, row0, nq, k0, d);
    stage_tile(xs, x, col0, nn, k0, d);
    __syncthreads();
    if (t < 2 * kTile) {  // warp-uniform: warps 0-1 rows, 2-3 columns
      const float* sh = t < kTile ? qs + t : xs + (t - kTile);
#pragma unroll
      for (int kk = 0; kk < kTileD; ++kk) norm = fmaf(sh[kk * kStride], sh[kk * kStride], norm);
    }
#pragma unroll
    for (int kk = 0; kk < kTileD; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = qs[kk * kStride + ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = xs[kk * kStride + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (t < kTile) {
    qn[t] = norm;
  } else if (t < 2 * kTile) {
    xn[t - kTile] = norm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int64_t row = row0 + ty + kSide * i;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int64_t col = col0 + tx + kSide * j;
      if (col < nn) {
        out[row * nn + col] =
            fmaxf(qn[ty + kSide * i] - 2.0f * acc[i][j] + xn[tx + kSide * j], 0.0f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Return a cudaError_t (0 = launched).  Launch on `stream`, no sync.
// bf16: 0 for float32 q and x, 1 for bf16; out is (nq, nn) float32.
int pairwise_l2_launch(const void* q, const void* x, float* out, int nq, int nn, int d,
                       int bf16, cudaStream_t stream) {
  const dim3 grid((nn + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  if (bf16) {
    pairwise_l2_kernel<__nv_bfloat16><<<grid, kL2Threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), out, nq,
        nn, d);
  } else {
    pairwise_l2_kernel<float><<<grid, kL2Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), out, nq, nn, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
