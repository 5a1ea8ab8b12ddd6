// Per-slot distance and window halfwidth kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference's pool engines:
//   * window_dist_kernel (repro/kernels/window_verify.py:217, wrapper
//     repro/kernels/ops.py:205) -> window_dist_kernel below (B4);
//   * candidate_dist_kernel (repro/kernels/window_verify.py:189, wrapper
//     repro/kernels/ops.py:149) -> candidate_dist_kernel below (B5).
//
// What both compute (twins: repro_torch/kernels/ref.py window_dist_ref,
// candidate_dist_ref): for each query and each of its candidate slots, the
// window halfwidth hw = max_k |p_k - g_k| against the slot's table's query
// projection, and the squared distance d2 (norm form max(||x||^2 - 2<q,x>
// + ||q||^2, 0), or diff form sum((x - q)^2)) into a flat (Q, C) pool,
// C = L*M*B (B4) or L*Ct (B5), table-major.  No window mask, no top-k: the
// caller applies the radius schedule to hw.  B4 reads the selected STR
// blocks of the flattened (L*nb) block axis in place and writes +inf to
// both outputs on every slot of an invalid block (id outside [0, L*nb)),
// in both forms, reading none of its rows; B5 reads pre-gathered
// candidates, where a +inf projection gives hw = +inf and a +inf norm
// d2 = +inf in norm form.
//
// Bound on this card: bytes.  Each slot reads K + d + 1 words and writes
// 2, against 3K + 2d operations (at the main path, Q = 64, S = 25, B = 64,
// K = 10, d = 64: ~31 MB read and 0.8 MB written, ~9.4 us at 3.35 TB/s),
// so the kernels stream at the memory rate at best; the design keeps many
// coalesced copies in flight:
//   * one body for both kernels (dist_body), a template over the
//     addressing policy (WindowRows, CandRows).  A unit of work is up to
//     `rows` (64) consecutive output slots of one query and one table whose
//     device rows are consecutive: B4, the rows of one selected block (a
//     block of B rows is ceil(B / rows) units); B5, up to 64 consecutive
//     candidates of one (query, table).  The policy gives a unit's first
//     device row, or -1 for an invalid B4 block;
//   * a persistent grid: the SM count x the blocks that fit on an SM
//     (prepare asks the runtime once per kernel and size); block b walks
//     units b, b + grid, ...  A block stages one unit at a time and the
//     latency of its copies is hidden by the SM's other blocks, so the
//     stage stays small and many blocks fit;
//   * a unit's rows are filled into a row table, then staged by cp.async
//     (copy_grid): x rows in 16-byte copies into padded rows
//     (padded_stride) where a row is whole 16-byte chunks on an aligned
//     base, else element by element; projection rows in 8-byte copies where
//     K is even and the base aligned, else 4-byte; norms, q2 and the unit's
//     table projection g in 4-byte copies; the query's q in 16-byte copies
//     where it is whole chunks on an aligned base.  A unit's rows are
//     consecutive in device memory, so neighbouring threads copy
//     neighbouring addresses of one contiguous span;
//   * each thread then takes one staged row: staged_hw, then
//     staged_d2<kNorm | kExact>, the chains every kernel computes a slot
//     with, so hw and d2 are bit-equal to the fused kernels' slots (the
//     pool, binned, equals B1's / B2's bins); q2 is the wrappers'
//     torch.sum(torch.square(q)), as B1/B2's;
//   * neighbouring threads write neighbouring output slots;
//   * 64-bit row and output offsets (the main path addresses 3.2e8 floats
//     of vec_blocks).

#include "search_common.cuh"

namespace {

using namespace dblsh;

constexpr int kDistThreads = 64;  // one thread per staged row
constexpr int kUnitRows = 64;     // rows of a unit (fewer where the stage would not fit)

// One unit of work: `n` output slots from `out`, device rows base .. base
// + n - 1 (base = -1: an invalid B4 block), of query qi in table `table`.
struct Unit {
  int64_t base, out;
  int qi, table, n;
};

struct DistArgs {
  const int* blk;  // B4: (Q, S) block ids
  const float* proj;
  const float* x;
  const float* nrm;
  const float* g;   // (Q, L, K)
  const float* q;   // (Q, d)
  const float* q2;  // (Q,)
  float* d2;
  float* hw;
  int S, M, lnb, B;  // B4: slot s of query qi is block blk[qi, s] of table s / M
  int L, Ct;         // B5: (Q, L, Ct) candidates
  int K, d;
  int64_t units;  // units of the launch
  int ub;         // units per (query, slot) in B4, per (query, table) in B5
  int rows;       // rows per unit
  int xstride;    // bytes per staged x row
  int kp;         // floats per staged projection row
  int xvec;       // x rows staged in 16-byte copies (and read 16 bytes at a time)
  int pvec;       // projection rows staged in 8-byte copies
  int qvec;       // q staged in 16-byte copies
  // byte offsets in the dynamic shared memory (the row table at 0)
  int o_x, o_proj, o_nrm, o_q, o_q2, o_g;
};

// B4: unit u is chunk u % ub of slot u / ub = qi * S + s, whose rows are
// those of block blk[qi, s] of the flattened (L*nb) axis.
struct WindowRows {
  __device__ static Unit unit(const DistArgs& a, int64_t u) {
    const int64_t qs = u / a.ub;
    const int c = (int)(u - qs * a.ub);
    Unit t;
    t.qi = (int)(qs / a.S);
    t.table = (int)(qs - (int64_t)t.qi * a.S) / a.M;
    const int b0 = c * a.rows;
    t.n = min(a.rows, a.B - b0);
    t.out = qs * a.B + b0;
    const int bk = __ldg(a.blk + qs);
    t.base = (bk >= 0 && bk < a.lnb) ? (int64_t)bk * a.B + b0 : -1;
    return t;
  }
};

// B5: unit u is chunk u % ub of (query, table) u / ub = qi * L + l, whose
// candidates are the dense rows (qi * L + l) * Ct + c, also their slots.
struct CandRows {
  __device__ static Unit unit(const DistArgs& a, int64_t u) {
    const int64_t ql = u / a.ub;
    const int c = (int)(u - ql * a.ub);
    Unit t;
    t.qi = (int)(ql / a.L);
    t.table = (int)(ql - (int64_t)t.qi * a.L);
    const int c0 = c * a.rows;
    t.n = min(a.rows, a.Ct - c0);
    t.out = ql * a.Ct + c0;
    t.base = t.out;
    return t;
  }
};

// The body of both kernels: for each of this block's units, fill its row
// table, stage its rows, then compute one row a thread.
template <class Rows, bool kDiff>
__device__ __forceinline__ void dist_body(const DistArgs& a) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int K = a.K, d = a.d, rowbytes = d * 4;
  int64_t* rowtab = reinterpret_cast<int64_t*>(smem);
  char* sx = smem + a.o_x;
  float* sp = reinterpret_cast<float*>(smem + a.o_proj);
  float* sn = reinterpret_cast<float*>(smem + a.o_nrm);
  float* sq = reinterpret_cast<float*>(smem + a.o_q);
  float* sq2 = reinterpret_cast<float*>(smem + a.o_q2);
  float* sg = reinterpret_cast<float*>(smem + a.o_g);

  for (int64_t u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit t = Rows::unit(a, u);  // the same in every thread
    // the unit's device rows, -1 past its end or for an invalid block
    for (int i = tid; i < a.rows; i += kDistThreads)
      rowtab[i] = (t.base >= 0 && i < t.n) ? t.base + i : -1;
    __syncthreads();  // the table is filled and the last unit's stage read
    if (t.base >= 0) {
      if (a.xvec) {
        copy_grid(rowtab, t.n, rowbytes >> 4, [&](int64_t row, int i, int c) {
          cp_async16(sx + (size_t)i * a.xstride + c * 16,
                     reinterpret_cast<const char*>(a.x) + row * rowbytes + c * 16);
        });
      } else {
        copy_grid(rowtab, t.n, d, [&](int64_t row, int i, int e) {
          cp_async4(sx + (size_t)i * a.xstride + e * 4, a.x + row * d + e);
        });
      }
      if (a.pvec) {
        copy_grid(rowtab, t.n, K >> 1, [&](int64_t row, int i, int k) {
          cp_async8(sp + i * a.kp + 2 * k, a.proj + row * K + 2 * k);
        });
      } else {
        copy_grid(rowtab, t.n, K, [&](int64_t row, int i, int k) {
          cp_async4(sp + i * a.kp + k, a.proj + row * K + k);
        });
      }
      const float* qsrc = a.q + (int64_t)t.qi * d;
      if (a.qvec) {
        for (int i = tid; i < d / 4; i += kDistThreads) cp_async16(sq + 4 * i, qsrc + 4 * i);
      } else {
        for (int i = tid; i < d; i += kDistThreads) cp_async4(sq + i, qsrc + i);
      }
      const float* gsrc = a.g + ((int64_t)t.qi * a.L + t.table) * K;
      for (int k = tid; k < K; k += kDistThreads) cp_async4(sg + k, gsrc + k);
      if constexpr (!kDiff) {
        for (int i = tid; i < t.n; i += kDistThreads) cp_async4(sn + i, a.nrm + t.base + i);
        if (tid == 0) cp_async4(sq2, a.q2 + t.qi);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float qq = kDiff ? 0.0f : *sq2;
    for (int i = tid; i < t.n; i += kDistThreads) {
      float dv = INFINITY, hv = INFINITY;
      if (t.base >= 0) {
        hv = staged_hw(sp + i * a.kp, a.pvec != 0, sg, K);
        dv = staged_d2<kDiff ? kExact : kNorm>(sx + (size_t)i * a.xstride, a.xvec != 0, sq,
                                                nullptr, d, kDiff ? 0.0f : sn[i], qq, 0.0f,
                                                0.0f);
      }
      a.d2[t.out + i] = dv;
      a.hw[t.out + i] = hv;
    }
  }
}

template <bool kDiff>
__global__ void __launch_bounds__(kDistThreads) window_dist_kernel(const DistArgs a) {
  dist_body<WindowRows, kDiff>(a);
}

template <bool kDiff>
__global__ void __launch_bounds__(kDistThreads) candidate_dist_kernel(const DistArgs a) {
  dist_body<CandRows, kDiff>(a);
}

// The shared-memory plan of one block: the row table, then one unit's
// stage of `rows` rows (x, projections, norms) with its q, q2 and g.
struct Plan {
  int rows, xstride;
  size_t o_x, o_proj, o_nrm, o_q, o_q2, o_g, total;
};

Plan plan_rows(int K, int d, int rows) {
  Plan p;
  p.rows = rows;
  p.xstride = padded_stride(4 * d);
  p.o_x = align16((size_t)rows * 8);
  p.o_proj = align16(p.o_x + (size_t)rows * p.xstride);
  p.o_nrm = align16(p.o_proj + (size_t)rows * (K | 1) * 4);  // the 4-byte path's odd stride
  p.o_q = align16(p.o_nrm + (size_t)rows * 4);
  p.o_q2 = align16(p.o_q + (size_t)d * 4);
  p.o_g = align16(p.o_q2 + 4);
  p.total = p.o_g + (size_t)K * 4;
  return p;
}

// 64 rows a unit, or the largest power of two below whose stage fits.
Plan plan(int K, int d) {
  int rows = kUnitRows;
  Plan p = plan_rows(K, d, rows);
  while (rows > 1 && p.total > kMaxSmem) p = plan_rows(K, d, rows /= 2);
  return p;
}

// Plan the block for `a`'s K and d, split each of `items` (B4: selected
// blocks of `per` = B rows; B5: (query, table) pairs of `per` = Ct
// candidates) into units, size the persistent grid and launch.
template <typename Kernel>
int launch(Kernel kernel, DistArgs& a, int64_t items, int per, cudaStream_t stream) {
  const Plan p = plan(a.K, a.d);
  if (p.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.rows = p.rows;
  a.ub = (per + p.rows - 1) / p.rows;
  a.units = items * a.ub;
  a.xstride = p.xstride;
  a.xvec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.pvec = a.K % 2 == 0 && reinterpret_cast<uintptr_t>(a.proj) % 8 == 0;
  a.kp = a.pvec ? a.K : (a.K | 1);
  a.qvec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.q) % 16 == 0;
  a.o_x = (int)p.o_x;
  a.o_proj = (int)p.o_proj;
  a.o_nrm = (int)p.o_nrm;
  a.o_q = (int)p.o_q;
  a.o_q2 = (int)p.o_q2;
  a.o_g = (int)p.o_g;
  int per_sm = 1;
  const int err = prepare(kernel, p.total, kDistThreads, &per_sm);
  if (err != 0) return err;
  const int64_t resident = (int64_t)per_sm * sm_count();
  const unsigned grid = (unsigned)(a.units < resident ? a.units : resident);
  kernel<<<grid, kDistThreads, p.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of either kernel (its plan for K, d).
size_t dist_smem_bytes(int K, int d) { return plan(K, d).total; }

// Return a cudaError_t (0 = launched).  Launch on `stream`, no sync.
// q2: (Q,) squared norms of the queries (read in norm form only).
int window_dist_launch(const int* blk, const float* proj, const float* vec,
                       const float* nrm, const float* g, const float* q, const float* q2,
                       float* d2, float* hw, int Q, int S, int M, int lnb, int B, int K,
                       int d, int L, int exact, cudaStream_t stream) {
  DistArgs a = {};
  a.blk = blk;
  a.proj = proj;
  a.x = vec;
  a.nrm = nrm;
  a.g = g;
  a.q = q;
  a.q2 = q2;
  a.d2 = d2;
  a.hw = hw;
  a.S = S;
  a.M = M;
  a.lnb = lnb;
  a.B = B;
  a.L = L;
  a.K = K;
  a.d = d;
  const int64_t slots = (int64_t)Q * S;  // selected blocks of B rows
  return exact ? launch(window_dist_kernel<true>, a, slots, B, stream)
               : launch(window_dist_kernel<false>, a, slots, B, stream);
}

int candidate_dist_launch(const float* cproj, const float* cvec, const float* cnrm,
                          const float* g, const float* q, const float* q2, float* d2,
                          float* hw, int Q, int L, int Ct, int K, int d, int exact,
                          cudaStream_t stream) {
  DistArgs a = {};
  a.proj = cproj;
  a.x = cvec;
  a.nrm = cnrm;
  a.g = g;
  a.q = q;
  a.q2 = q2;
  a.d2 = d2;
  a.hw = hw;
  a.L = L;
  a.Ct = Ct;
  a.K = K;
  a.d = d;
  const int64_t tables = (int64_t)Q * L;  // (query, table) pairs of Ct candidates
  return exact ? launch(candidate_dist_kernel<true>, a, tables, Ct, stream)
               : launch(candidate_dist_kernel<false>, a, tables, Ct, stream);
}

}  // extern "C"
