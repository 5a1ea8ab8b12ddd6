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
// 67 TFLOP/s, so operations bound it at Q = 1024 (2.00 ms with the norms
// and the epilogue); at Q = 64 X's 256 MB read and the 256 MB matrix bound
// it (0.153 ms), the 8.6 GFLOP of FMAs (0.128 ms) close behind.
//
// Both kernels share the tile and its order:
//   * one 256-thread block per output tile, 8 warps, each warp a 64 x 32
//     piece of float32 accumulators in registers: 128 x 128 tiles (warps
//     2 (rows) x 4 (columns)); in float32 with nq <= 64, 64 x 256 tiles
//     (warps 1 x 8), so that no warp of a block is idle;
//   * grid (Q row tiles, X row tiles): the row tiles vary fastest, so the
//     blocks sharing one X tile run together and X comes from device
//     memory about once, while Q stays in L2.  nn / 128 tiles must fit the
//     grid's y extent (nn <= 8,388,480);
//   * a warp whose 64 rows all lie past nq does no products and no stores
//     (warp-uniform);
//   * ||q||^2 and ||x||^2 in float32 fmaf from the staged values, one
//     thread per row, in the order of d, never on the tensor cores;
//   * one epilogue (store_piece): the accumulators staged through shared
//     memory per warp (stride 40 floats), ||q||^2 - 2 acc + ||x||^2 and the
//     clamp at 0, then 16-byte streaming stores (st.global.cs: the matrix
//     does not evict X and Q from L2), a warp covering four whole 128-byte
//     lines; scalar stores at the ragged column edge and on rows not
//     16-byte aligned (nn % 4 != 0);
//   * zeros staged outside the matrices and past d; 64-bit row and output
//     offsets (nq * nn passes 2^31 at Q >= 2148 against n = 1M).
//
// bf16 design (pairwise_l2_kernel_bf16), against the bytes:
//   * each warp's piece is 4 x 4 mma tiles of 16 x 8 (mma.sync m16n8k16,
//     fragments by ldmatrix.x4);
//   * d in steps of 64: both tiles staged as bf16 in shared memory, rows
//     padded by 8 elements (144 bytes: ldmatrix and the norms' 16-byte
//     reads are free of bank conflicts).  16-byte cp.async where every row
//     starts 16-byte aligned (d % 8 == 0), element loads otherwise.
//
// float32 design (pairwise_l2_kernel<kWM>), against the FMA rate
// (each of the 131 GFLOP at Q = 1024 is one fmaf, and at Q = 64 the FMAs
// take nearly as long as the bytes):
//   * each lane an 8 x 8 micro-tile (rows 4 lr + i and 32 + 4 lr + i of
//     its warp's piece, i < 4, lr = lane / 4; columns 8 lc + j, j < 8,
//     lc = lane % 4): per k, four 16-byte shared-memory reads feed 64
//     FMAs.  The Q reads of a warp are 128 consecutive bytes, the X reads
//     a broadcast of 4 addresses: free of bank conflicts;
//   * d in steps of 16 through k-major tiles (sh[k * (rows + 4) + r]: the
//     padding keeps each k-row 16-byte aligned), double-buffered: the next
//     step is loaded into registers (16-byte reads where d % 4 == 0 and
//     the bases are 16-byte aligned, four element loads otherwise) while
//     the current one is multiplied, then stored transposed; one
//     __syncthreads per step;
//   * every output is one fmaf chain over k = 0 .. d - 1 in order (zeros
//     past d add nothing), and so is each norm: the matrix does not depend
//     on the tile or the step;
//   * 2 blocks of 256 threads per SM (at most 128 registers a thread, no
//     spills).  What is left between it and the bound at Q = 1024: the
//     other instructions of each step (the shared-memory reads, the
//     staging, the norms) take instruction slots from the FMAs, and the
//     epilogue's stores overlap little with the products, since the
//     resident blocks run in step.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 128;      // bf16 output tile edge (Q rows, X rows)
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarpRows = 64;   // a warp's piece: 64 rows x 32 columns
constexpr int kWarpCols = 32;
constexpr int kEpiRow = kWarpCols + 8;  // epilogue staging row, in floats

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

// The epilogue of both kernels.  A warp writes kRows x 32 outputs: rows
// lr0.., columns lc0.. of the tile at (row0, col0), from the products
// staged at stage[r * kEpiRow + c], as max(qn - 2 acc + xn, 0).  Lanes
// 8r..8r+7 cover one 32-float row: 16-byte streaming stores, four whole
// 128-byte lines per instruction; scalar stores at the ragged column edge
// and where rows are not 16-byte aligned (!vec_store).  Rows past nq are
// not written.
template <int kRows>
__device__ inline void store_piece(const float* stage, const float* qn, const float* xn,
                                   int lr0, int lc0, float* __restrict__ out, int64_t row0,
                                   int64_t col0, int nq, int nn, bool vec_store) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < kRows / 4; ++p) {
    const int r = p * 4 + (lane >> 3), c = (lane & 7) * 4;
    const int lr = lr0 + r, lc = lc0 + c;
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
}

// ------------------------------------------------------------- float32

constexpr int kFStep = 16;  // d per staged step

// Rows [0, kRows) x d-columns [k0, k0 + 16) of a row-major (rows, d)
// float32 block `src` (its first `rows` rows real) into registers, zeros
// past `rows` and past d: chunk c = t + 256 l is row c / 4, columns
// 4 (c % 4) .. + 3 (a warp reads 8 rows x 64 bytes).  With `aligned`
// (d % 4 == 0 and 16-byte aligned bases) one 16-byte read, wholly inside d
// or wholly past it; otherwise four element loads.
template <int kRows>
__device__ inline void load_f32(float4 (&v)[kRows / 64], const float* __restrict__ src,
                                int rows, int k0, int d, bool aligned) {
  const int r = threadIdx.x >> 2, k = k0 + (threadIdx.x & 3) * 4;
  const float* from = src + (int64_t)r * d + k;
#pragma unroll
  for (int l = 0; l < kRows / 64; ++l) {
    const bool in = r + 64 * l < rows;
    const float* p = from + (int64_t)64 * l * d;
    if (aligned) {
      v[l] = in && k < d ? *reinterpret_cast<const float4*>(p)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      v[l] = make_float4(in && k < d ? p[0] : 0.0f, in && k + 1 < d ? p[1] : 0.0f,
                         in && k + 2 < d ? p[2] : 0.0f, in && k + 3 < d ? p[3] : 0.0f);
    }
  }
}

// The registers of load_f32, transposed into sh[k * (kRows + 4) + r].
template <int kRows>
__device__ inline void store_f32(float* sh, const float4 (&v)[kRows / 64]) {
#pragma unroll
  for (int l = 0; l < kRows / 64; ++l) {
    const int c = threadIdx.x + l * kThreads;
    float* p = sh + (c & 3) * 4 * (kRows + 4) + (c >> 2);
    p[0] = v[l].x;
    p[kRows + 4] = v[l].y;
    p[2 * (kRows + 4)] = v[l].z;
    p[3 * (kRows + 4)] = v[l].w;
  }
}

// kWM = 2: 128 x 128 tiles, warps 2 (rows) x 4 (columns); kWM = 1: 64 x
// 256 tiles, warps 1 x 8, for nq <= 64 (every warp has rows to compute).
template <int kWM>
struct F32Tile {
  static constexpr int kWN = 8 / kWM;
  static constexpr int kQ = kWarpRows * kWM;  // Q rows (output rows)
  static constexpr int kX = kWarpCols * kWN;  // X rows (output columns)
  static constexpr int kQRow = kQ + 4;        // staged k-rows, in floats
  static constexpr int kXRow = kX + 4;
  static constexpr int kStep = kFStep * (kQRow + kXRow);  // one step of both
  static constexpr int kSmem = 2 * kStep > 8 * 32 * kEpiRow ? 2 * kStep : 8 * 32 * kEpiRow;
};

template <int kWM>
__global__ void __launch_bounds__(kThreads, 2) pairwise_l2_kernel(
    const float* __restrict__ q, const float* __restrict__ x, float* __restrict__ out, int nq,
    int nn, int d, bool aligned, bool vec_store) {
  using T = F32Tile<kWM>;
  // two buffers of (Q step, X step); the epilogue's staging reuses them
  __shared__ __align__(16) float smem[T::kSmem];
  __shared__ float qn[T::kQ];
  __shared__ float xn[T::kX];
  const int64_t row0 = (int64_t)blockIdx.x * T::kQ;  // rows of Q, of the output
  const int64_t col0 = (int64_t)blockIdx.y * T::kX;  // rows of X, columns of the output
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wm = (t >> 5) / T::kWN, wn = (t >> 5) % T::kWN;  // piece: rows wm*64, cols wn*32
  const int lr = lane >> 2, lc = lane & 3;
  const bool active = row0 + wm * kWarpRows < nq;  // warp-uniform: any of its rows real
  const int a_off = wm * kWarpRows + lr * 4;       // the lane's rows: + i and + 32 + i
  const int b_off = wn * kWarpCols + lc * 8;       // the lane's columns: + j
  float acc[8][8] = {};
  // ||.||^2 of staged row t (Q rows first, then X rows), and of row t + 256
  // where the tile has more than 256 (kWM = 1: X rows 192..255)
  float norm = 0.0f, norm2 = 0.0f;
  const float* qb = q + row0 * d;
  const float* xb = x + col0 * d;
  const int q_rows = nq - row0 < T::kQ ? (int)(nq - row0) : T::kQ;
  const int x_rows = nn - col0 < T::kX ? (int)(nn - col0) : T::kX;
  float4 pq[T::kQ / 64], px[T::kX / 64];
  load_f32<T::kQ>(pq, qb, q_rows, 0, d, aligned);
  load_f32<T::kX>(px, xb, x_rows, 0, d, aligned);
  store_f32<T::kQ>(smem, pq);
  store_f32<T::kX>(smem + kFStep * T::kQRow, px);
  __syncthreads();
  const int steps = (d + kFStep - 1) / kFStep;
  for (int s = 0; s < steps; ++s) {
    const float* qs = smem + (s & 1) * T::kStep;
    const float* xs = qs + kFStep * T::kQRow;
    const bool more = s + 1 < steps;
    if (more) {  // in flight while this step is multiplied
      load_f32<T::kQ>(pq, qb, q_rows, (s + 1) * kFStep, d, aligned);
      load_f32<T::kX>(px, xb, x_rows, (s + 1) * kFStep, d, aligned);
    }
    {  // one row per thread, in the order of d
      const float* sh = t < T::kQ ? qs + t : xs + (t - T::kQ);
      const int stride = t < T::kQ ? T::kQRow : T::kXRow;
#pragma unroll
      for (int kk = 0; kk < kFStep; ++kk) norm = fmaf(sh[kk * stride], sh[kk * stride], norm);
      if (T::kQ + T::kX > kThreads && t + kThreads < T::kQ + T::kX) {
        const float* sh2 = xs + (t + kThreads - T::kQ);
#pragma unroll
        for (int kk = 0; kk < kFStep; ++kk) {
          norm2 = fmaf(sh2[kk * T::kXRow], sh2[kk * T::kXRow], norm2);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kFStep; ++kk) {
        const float* qk = qs + kk * T::kQRow + a_off;
        const float* xk = xs + kk * T::kXRow + b_off;
        const float4 a0 = *reinterpret_cast<const float4*>(qk);
        const float4 a1 = *reinterpret_cast<const float4*>(qk + 32);
        const float4 b0 = *reinterpret_cast<const float4*>(xk);
        const float4 b1 = *reinterpret_cast<const float4*>(xk + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) {
      float* next = smem + ((s + 1) & 1) * T::kStep;
      store_f32<T::kQ>(next, pq);
      store_f32<T::kX>(next + kFStep * T::kQRow, px);
    }
    __syncthreads();
  }
  if (t < T::kQ) {
    qn[t] = norm;
  } else {
    xn[t - T::kQ] = norm;
  }
  if (T::kQ + T::kX > kThreads && t + kThreads < T::kQ + T::kX) {
    xn[t + kThreads - T::kQ] = norm2;
  }
  __syncthreads();
  if (!active) return;
  // Epilogue in two 32-row halves of the warp's piece: half m holds the
  // lane's rows 4 lr + i (acc[4 m + i]) and columns 8 lc + j.
  float* stage = smem + (t >> 5) * 32 * kEpiRow;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = 4 * m + i;
      float* p = stage + (lr * 4 + i) * kEpiRow + lc * 8;
      *reinterpret_cast<float4*>(p) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
    }
    __syncwarp();
    store_piece<32>(stage, qn, xn, wm * kWarpRows + m * 32, wn * kWarpCols, out, row0, col0,
                    nq, nn, vec_store);
    __syncwarp();
  }
}

template <int kWM>
void launch_f32(const float* q, const float* x, float* out, int nq, int nn, int d,
                bool aligned, bool vec_store, cudaStream_t stream) {
  using T = F32Tile<kWM>;
  const dim3 grid((nq + T::kQ - 1) / T::kQ, (nn + T::kX - 1) / T::kX);
  pairwise_l2_kernel<kWM><<<grid, kThreads, 0, stream>>>(q, x, out, nq, nn, d, aligned,
                                                         vec_store);
}

// ---------------------------------------------------------------- bf16

constexpr int kBStep = 64;                // d per staged step
constexpr int kBRow = kBStep + 8;         // staged row, in bf16 elements (144 bytes)
constexpr int kMTiles = kWarpRows / 16;   // a warp's piece: 4 x 4 mma tiles of 16 x 8
constexpr int kNTiles = kWarpCols / 8;
static_assert(8 * 16 * kEpiRow * 4 <= 2 * kTile * kBRow * 2,
              "the epilogue's staging must fit in the tiles' space");

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
    for (int c = t; c < kTile * (kBStep / 8); c += kThreads) {
      const int r = c >> 3, k = (c & 7) * 8;
      const int64_t row = row0 + r;
      const bool valid = row < rows && k0 + k < d;
      cp_async16(sh + r * kBRow + k, valid ? src + row * d + k0 + k : src, valid);
    }
  } else {
    for (int e = t; e < kTile * kBStep; e += kThreads) {
      const int r = e / kBStep, k = e % kBStep;
      const int64_t row = row0 + r;
      sh[r * kBRow + k] = (row < rows && k0 + k < d) ? src[row * d + k0 + k] : uint16_t{0};
    }
  }
}

__device__ inline float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ inline float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void __launch_bounds__(kThreads, 2) pairwise_l2_kernel_bf16(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ x, float* __restrict__ out,
    int nq, int nn, int d, bool aligned, bool vec_store) {
  __shared__ __align__(16) uint16_t tiles[2 * kTile * kBRow];
  __shared__ float qn[kTile];
  __shared__ float xn[kTile];
  uint16_t* qs = tiles;
  uint16_t* xs = tiles + kTile * kBRow;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;  // rows of Q, of the output
  const int64_t col0 = (int64_t)blockIdx.y * kTile;  // rows of X, columns of the output
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
      const uint4* row = reinterpret_cast<const uint4*>(t < kTile ? qs + t * kBRow
                                                                  : xs + (t - kTile) * kBRow);
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
  if (t < kTile) {
    qn[t] = norm;
  } else {
    xn[t - kTile] = norm;
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
    store_piece<16>(stage, qn, xn, wm * kWarpRows + i * 16, wn * kWarpCols, out, row0, col0,
                    nq, nn, vec_store);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Return a cudaError_t (0 = launched).  Launch on `stream`, no sync.
// bf16: 0 for float32 q and x, 1 for bf16; out is (nq, nn) float32.  nn
// must be at most 65,535 * 128 (the grid's y extent in 128-row tiles).
int pairwise_l2_launch(const void* q, const void* x, float* out, int nq, int nn, int d,
                       int bf16, cudaStream_t stream) {
  const bool vec_store = nn % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (bf16) {
    const dim3 grid((nq + kTile - 1) / kTile, (nn + kTile - 1) / kTile);
    const bool aligned = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0;
    pairwise_l2_kernel_bf16<<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(x), out, nq, nn, d,
        aligned, vec_store);
  } else {
    const bool aligned = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const auto launch = nq <= kWarpRows ? launch_f32<1> : launch_f32<2>;
    launch(static_cast<const float*>(q), static_cast<const float*>(x), out, nq, nn, d, aligned,
           vec_store, stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
