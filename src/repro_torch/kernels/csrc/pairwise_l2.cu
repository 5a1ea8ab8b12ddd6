// Squared-L2 distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pairwise_l2_kernel
// (repro/kernels/pairwise_l2.py:25, wrapper repro/kernels/ops.py:444):
// D2[i, j] = max(||Q_i||^2 - 2 Q_i.X_j + ||X_j||^2, 0), (nq, nn) float32,
// for float32 or bf16 inputs.  The TPU kernel runs the product on the MXU
// with float32 accumulation.  Here each input type has its own kernel:
//
//   * bf16: pairwise_l2_kernel_bf16, the product on the tensor cores
//     (mma.sync m16n8k16, bf16 x bf16 -> float32).  A bf16 x bf16 product
//     is exact in float32, so it computes what the TPU kernel computes, up
//     to the order of the sum;
//   * float32: pairwise_l2_kernel, plain float32 FMAs on the FMA units,
//     never TF32.
//
// Bound on this card.  Against n = 1M points of d = 64, Q = 1024 queries
// write a 4.1 GB float32 matrix (1.22 ms at 3.35 TB/s).  bf16: 131 GFLOP
// is 0.13 ms at the tensor cores' 989 TFLOP/s, so the output's bytes bound
// it at every batch (1.26 ms at Q = 1024, 0.115 ms at Q = 64, where X's
// 128 MB read counts too).  float32: the same 131 GFLOP take 1.96 ms at
// 67 TFLOP/s, so operations bound it at Q = 1024, bytes at Q = 64.
//
// bf16 design (pairwise_l2_kernel_bf16), against the bytes:
//   * one 256-thread block per 128 x 128 output tile, 8 warps as 2 (rows)
//     x 4 (columns), each warp a 64 x 32 piece of float32 accumulators in
//     registers (4 x 4 mma tiles of 16 x 8);
//   * d in steps of 64: both tiles staged as bf16 in shared memory, rows
//     padded by 8 elements (144 bytes: ldmatrix and the norms' 16-byte
//     reads are free of bank conflicts), zeros outside the matrix and past
//     d.  16-byte cp.async where every row starts 16-byte aligned
//     (d % 8 == 0), element loads otherwise;
//   * fragments by ldmatrix.x4; ||q||^2 and ||x||^2 in float32 fmaf from
//     the staged bf16 values, one thread per row, in the order of d (as
//     the float32 kernel), never on the tensor cores;
//   * grid (Q row tiles, X row tiles): the row tiles vary fastest, so the
//     blocks sharing one X tile run together and X comes from device
//     memory about once, while Q stays in L2.  nn / 128 tiles must fit the
//     grid's y extent (nn <= 8,388,480);
//   * epilogue per warp and 16-row slice: the accumulators staged through
//     shared memory (the tiles' space, stride 40 floats: conflict-free),
//     ||q||^2 - 2 acc + ||x||^2 and the clamp at 0, then 16-byte streaming
//     stores (st.global.cs: the matrix does not evict X and Q from L2), a
//     warp covering four whole 128-byte lines; scalar stores at the ragged
//     column edge and on rows not 16-byte aligned (nn % 4 != 0);
//   * 64-bit row and output offsets (nq * nn passes 2^31 at Q >= 2148
//     against n = 1M).
//
// float32 design (pairwise_l2_kernel, a plain tiled kernel):
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
//     stores skipped), no padded copies; 64-bit row and output offsets.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ------------------------------------------------------------- float32

constexpr int kTile = 64;   // output tile edge
constexpr int kTileD = 32;  // d per shared-memory tile
constexpr int kStride = kTile + 1;
constexpr int kSide = 16;   // threads per tile edge; each owns 4 x 4 outputs
constexpr int kMicro = kTile / kSide;
constexpr int kL2Threads = kSide * kSide;

// Stage rows [row0, row0 + 64) x columns [k0, k0 + 32) of a row-major
// (rows, d) matrix into sh[k * kStride + r], zero outside the matrix.
// Lane = k: a warp reads 32 consecutive elements of one row.
__device__ inline void stage_tile(float* sh, const float* __restrict__ src, int64_t row0,
                                  int rows, int k0, int d) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + lane;
  for (int r = threadIdx.x >> 5; r < kTile; r += kL2Threads / 32) {
    const int64_t row = row0 + r;
    sh[lane * kStride + r] = (row < rows && k < d) ? src[row * d + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(kL2Threads) pairwise_l2_kernel(
    const float* __restrict__ q, const float* __restrict__ x, float* __restrict__ out, int nq,
    int nn, int d) {
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

// ---------------------------------------------------------------- bf16

constexpr int kBTile = 128;            // output tile edge (Q rows, X rows)
constexpr int kBStep = 64;             // d per staged step
constexpr int kBRow = kBStep + 8;      // staged row, in bf16 elements (144 bytes)
constexpr int kBThreads = 256;         // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpRows = 64;          // a warp's piece: 64 rows x 32 columns,
constexpr int kWarpCols = 32;          //   4 x 4 mma tiles of 16 x 8
constexpr int kMTiles = kWarpRows / 16;
constexpr int kNTiles = kWarpCols / 8;
constexpr int kEpiRow = kWarpCols + 8;  // epilogue staging row, in floats
static_assert(8 * 16 * kEpiRow * 4 <= 2 * kBTile * kBRow * 2,
              "the epilogue's staging must fit in the tiles' space");

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// when !valid (src is then only a placeholder address and is not read).
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) x b (16 x 8, column-major); bf16 in, float32 sums
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [row0, row0 + 128) x d-columns [k0, k0 + 64) of a row-major
// (rows, d) bf16 matrix into sh[r * kBRow + k], zero outside the matrix.
// With `aligned` (d % 8 == 0 and a 16-byte aligned base) each thread
// copies 16-byte chunks with cp.async, which lie wholly inside d or
// wholly past it (the caller waits for them); otherwise one element at a
// time.
__device__ inline void stage_bf16(uint16_t* sh, const uint16_t* __restrict__ src, int64_t row0,
                                  int rows, int k0, int d, bool aligned) {
  const int t = threadIdx.x;
  if (aligned) {
    for (int c = t; c < kBTile * (kBStep / 8); c += kBThreads) {
      const int r = c >> 3, k = (c & 7) * 8;
      const int64_t row = row0 + r;
      const bool valid = row < rows && k0 + k < d;
      cp_async16(sh + r * kBRow + k, valid ? src + row * d + k0 + k : src, valid);
    }
  } else {
    for (int e = t; e < kBTile * kBStep; e += kBThreads) {
      const int r = e / kBStep, k = e % kBStep;
      const int64_t row = row0 + r;
      sh[r * kBRow + k] = (row < rows && k0 + k < d) ? src[row * d + k0 + k] : uint16_t{0};
    }
  }
}

__device__ inline float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ inline float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void __launch_bounds__(kBThreads, 2) pairwise_l2_kernel_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ x, float* __restrict__ out,
    int nq, int nn, int d, bool aligned, bool vec_store) {
  __shared__ __align__(16) uint16_t tiles[2 * kBTile * kBRow];
  __shared__ float qn[kBTile];
  __shared__ float xn[kBTile];
  uint16_t* qs = tiles;
  uint16_t* xs = tiles + kBTile * kBRow;
  const int64_t row0 = (int64_t)blockIdx.x * kBTile;  // rows of Q, of the output
  const int64_t col0 = (int64_t)blockIdx.y * kBTile;  // rows of X, columns of the output
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wm = (t >> 5) / 4, wn = (t >> 5) % 4;  // the warp's piece: rows wm*64, cols wn*32
  const bool active = row0 + wm * kWarpRows < nq;  // warp-uniform: any of its rows real
  float acc[kMTiles][kNTiles][4] = {};
  float norm = 0.0f;  // t < 128: ||Q_{row0+t}||^2; else ||X_{col0+t-128}||^2
  // ldmatrix row addresses: A (Q) matrices rows 0-7 / 8-15 x k 0-7 / 8-15 in
  // the order of a0..a3; B (X) matrices n 0-7 k 0-7, n 0-7 k 8-15, n 8-15
  // k 0-7, n 8-15 k 8-15, so that regs 0/1 and 2/3 are two n-tiles' b0/b1
  const uint16_t* a_base = qs + (wm * kWarpRows + (lane & 15)) * kBRow + (lane >> 4) * 8;
  const uint16_t* b_base =
      xs + (wn * kWarpCols + (lane & 7) + ((lane >> 4) << 3)) * kBRow + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < d; k0 += kBStep) {
    stage_bf16(qs, q, row0, nq, k0, d, aligned);
    stage_bf16(xs, x, col0, nn, k0, d, aligned);
    if (aligned) cp_async_wait_all();
    __syncthreads();
    {  // one row per thread, in the order of d; 16-byte reads of 8 values
      const uint4* row = reinterpret_cast<const uint4*>(t < kBTile ? qs + t * kBRow
                                                                   : xs + (t - kBTile) * kBRow);
#pragma unroll
      for (int c = 0; c < kBStep / 8; ++c) {
        const uint4 v = row[c];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          norm = fmaf(bf16_lo(w[u]), bf16_lo(w[u]), norm);
          norm = fmaf(bf16_hi(w[u]), bf16_hi(w[u]), norm);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBStep; kk += 16) {
        uint32_t a[kMTiles][4], b[kNTiles][2];
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) ldmatrix_x4(a[i], a_base + i * 16 * kBRow + kk);
#pragma unroll
        for (int jj = 0; jj < kNTiles / 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4(r, b_base + jj * 16 * kBRow + kk);
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < kMTiles; ++i)
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }
  if (t < kBTile) {
    qn[t] = norm;
  } else {
    xn[t - kBTile] = norm;
  }
  __syncthreads();
  if (!active) return;
  // Epilogue, one 16-row slice of the warp's piece at a time.  Accumulator
  // (i, j) holds, per lane, rows g and g + 8, columns 2 tig and 2 tig + 1
  // of its 16 x 8 tile (g = lane / 4, tig = lane % 4).
  float* stage = reinterpret_cast<float*>(tiles) + (t >> 5) * 16 * kEpiRow;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      float* p = stage + g * kEpiRow + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + 8 * kEpiRow) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // lanes 8r..8r+7 cover one 32-float row
      const int r = p * 4 + (lane >> 3), c = (lane & 7) * 4;
      const int lr = wm * kWarpRows + i * 16 + r, lc = wn * kWarpCols + c;
      const int64_t row = row0 + lr, col = col0 + lc;
      if (row >= nq) continue;
      const float4 s = *reinterpret_cast<const float4*>(stage + r * kEpiRow + c);
      const float qv = qn[lr];
      const float v[4] = {fmaxf(qv - 2.0f * s.x + xn[lc], 0.0f),
                          fmaxf(qv - 2.0f * s.y + xn[lc + 1], 0.0f),
                          fmaxf(qv - 2.0f * s.z + xn[lc + 2], 0.0f),
                          fmaxf(qv - 2.0f * s.w + xn[lc + 3], 0.0f)};
      float* o = out + row * nn + col;
      if (vec_store && col + 3 < nn) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
      } else {
        for (int e = 0; e < 4 && col + e < nn; ++e) __stcs(o + e, v[e]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Return a cudaError_t (0 = launched).  Launch on `stream`, no sync.
// bf16: 0 for float32 q and x, 1 for bf16; out is (nq, nn) float32.  In
// bf16, nn must be at most 65,535 * 128 (the grid's y extent).
int pairwise_l2_launch(const void* q, const void* x, float* out, int nq, int nn, int d,
                       int bf16, cudaStream_t stream) {
  if (bf16) {
    const bool aligned = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vec_store = nn % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid((nq + kBTile - 1) / kBTile, (nn + kBTile - 1) / kBTile);
    pairwise_l2_kernel_bf16<<<grid, kBThreads, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(x), out, nq, nn, d,
        aligned, vec_store);
  } else {
    const dim3 grid((nn + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
    pairwise_l2_kernel<<<grid, kL2Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), out, nq, nn, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
