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
// Bound on this card: bytes.  The work is a gather of Q*S*B rows of
// K + 2 words, d elements and (quantized) a scale: at the main path
// (Q = 64, S = 25, B = 64, K = 10, d = 64) 31 MB in float32, ~9 us at
// 3.35 TB/s; bf16 rows 180 bytes a slot (~5.5 us), int8 116 (~3.6 us).
// The float32 arithmetic (3K + 2d per slot) is ~100x smaller.
//
// Design:
//   * one thread-block cluster per query, of `split` blocks (1, 2 or 4:
//     the launch takes the largest that keeps Q * split within the SM
//     count, so a batch of 64 queries fills 128 SMs); block r of the
//     cluster takes an r-th share of the query's slots (whole STR blocks
//     in B1) and the bins j with j % split == r;
//   * phase 1 (512 threads a block) stages the slots' rows in shared
//     memory, `rows` slots at a time, double-buffered with cp.async: x
//     rows in 16-byte copies where a row is a whole number of 16-byte
//     chunks and the base is aligned (else element by element),
//     projection rows in 8-byte copies where K is even (else 4-byte), the
//     per-slot words in 4-byte copies; neighbouring threads copy
//     neighbouring addresses, and a table of the stage's
//     device rows, filled two stages ahead, spares the copy loops any
//     division.  The stage size follows the grid (kStageBudget*).  The x
//     rows are padded so that the threads' 16-byte reads of their own
//     rows hit distinct banks.  Each thread then takes one staged slot:
//     hw, bin and (admitted slots) d2 from shared memory;
//   * a slot's d2 is one sequential chain over i = 0..d-1 (fmaf in float32
//     and bf16; in int8 an int32 sum, exact in any order, so taken four
//     products at a time with dp4a; then dequant_d2's rounded steps),
//     the same operations on the same values in every kernel that
//     computes a slot (search_common.cuh's staged_d2), so every copy of a point gives a bit-identical (d2, id) pair
//     and the one-pass exact=True search stays bit-equal to the
//     multi-pass oracle (B6/B7) and to the pool engines (B4/B5);
//   * bucketing: phase 1 keeps each slot's (d2, id) as a 64-bit key and
//     counts each bin's slots (cnt) and its slots with a finite d2
//     (shared-memory atomics on integer counts); a prefix sum and a
//     scatter give each bin a list of its slots;
//   * selection: one warp per bin walks the bin's list in the cluster
//     (distributed shared memory for the other blocks' lists) as 64-bit
//     keys ordered as (d2, id).  A key below the bin's current ks-th
//     distinct key joins a 512-key buffer; a full buffer (and the last)
//     is cut to its ks smallest distinct keys, which set the new
//     threshold: each lane sorts its (at most 16) keys in registers, then
//     ks rounds of a warp-wide minimum over the lanes' smallest keys pop
//     them (two 32-bit `redux` minima a round), a repeated key once.  The
//     result, the ks smallest distinct finite pairs, does not depend on
//     the order in which the scatter filled the lists, so the outputs are
//     deterministic.  A bin width ks > 480 (the buffer could not take a
//     warp's keys beside the kept ones) takes ks argmin rounds over the
//     bin's list.  Both are search_common.cuh's warp_topk, the rule B6/B7
//     select by;
//   * block bases use 64-bit element offsets (the main path addresses
//     3.2e8 floats of vec_blocks).

#include <cooperative_groups.h>

#include "search_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dblsh;

constexpr int kFusedThreads = 512;
constexpr int kWarps = kFusedThreads / 32;
// Bytes of the two stage buffers: a grid that fits the SMs once (one
// block an SM) takes large stages; a larger grid smaller ones, so that two
// blocks share an SM (the fastest of the sizes measured at Q = 64 / 1024).
constexpr size_t kStageBudgetOnce = 160 * 1024;
constexpr size_t kStageBudget = 96 * 1024;

__host__ __device__ constexpr bool quantized(int mode) { return mode == kBf16 || mode == kInt8; }
__host__ __device__ constexpr int x_bytes(int mode) {
  return mode == kBf16 ? 2 : mode == kInt8 ? 1 : 4;
}

// Everything a launch passes: the operands (B2 puts its gathered arrays in
// the same fields), the shape, and the shared-memory plan.
struct Args {
  const int* blk;  // (Q, S) block ids (B1 only)
  const float* proj;
  const void* x;
  const float* nrm;
  const int* ids;
  const float* xs;  // per-slot dequant scales (quantized modes)
  const float* halves;
  const float* g;
  const void* qv;
  const float* q2;
  const float* qs;
  float* bd;
  int* bi;
  int* cnt;
  int S, M, lnb, B;  // B1: slots are rows of the S selected blocks of B rows
  int Ct;            // B2: candidates per table
  int C, L, K, d, steps, ks, n;
  int split;         // blocks per query (the cluster's size)
  int rows;          // slots per stage buffer
  int xstride;       // bytes per staged x row
  int kp;            // floats per staged projection row
  int xvec;          // x rows staged in 16-byte copies
  int pvec;          // projection rows staged in 8-byte copies (even K, aligned)
  // byte offsets into the dynamic shared memory
  int o_g, o_q, o_qp, o_blk, o_hist, o_key, o_bin, o_list, o_rows, o_region, buf_bytes;
  // within a stage buffer
  int b_proj, b_nrm, b_id, b_xs;
};

// The shared-memory plan of one block for a pool of `cap` slots.
struct Plan {
  int rows, xstride, kp;
  size_t o_g, o_q, o_qp, o_blk, o_hist, o_key, o_bin, o_list, o_rows, o_region, buf_bytes, total;
  size_t b_proj, b_nrm, b_id, b_xs;
};

size_t buffer_bytes(int rows, int xstride, int kp, Plan* p) {
  size_t off = align16((size_t)rows * xstride);
  if (p) p->b_proj = off;
  off = align16(off + (size_t)rows * kp * 4);
  if (p) p->b_nrm = off;
  off = align16(off + (size_t)rows * 4);
  if (p) p->b_id = off;
  off = align16(off + (size_t)rows * 4);
  if (p) p->b_xs = off;
  return align16(off + (size_t)rows * 4);
}

// Counts and slot arrays are sized by `cap` (< 65,536: the plan of a pool
// that large exceeds kMaxSmem, so bins and list entries fit in 16 bits);
// the two stage buffers take at most `budget` bytes.
Plan plan(int mode, int steps, int L, int K, int d, int S, int cap, size_t budget) {
  Plan p;
  p.xstride = padded_stride(d * x_bytes(mode));
  p.kp = K | 1;  // the 4-byte path's odd stride; the 8-byte path's K is smaller
  size_t off = align16((size_t)steps * 4);
  p.o_g = off;
  off = align16(off + (size_t)L * K * 4);
  p.o_q = off;
  off = align16(off + (size_t)d * 4);
  p.o_qp = off;  // int8: the query packed, 4 elements a word
  off = align16(off + (size_t)d);
  p.o_blk = off;
  off = align16(off + (size_t)S * 4);
  p.o_hist = off;
  off = align16(off + (size_t)4 * steps * 4);
  p.o_key = off;
  off = align16(off + (size_t)cap * 8);
  p.o_bin = off;
  off = align16(off + (size_t)cap * 2);
  p.o_list = off;
  off = align16(off + (size_t)cap * 2);
  p.o_rows = off;  // the row table, 3 stages of rows (sized below)
  // a selection buffer for each warp that can own a bin (warp w < steps)
  const size_t sort_bytes = (size_t)(steps < kWarps ? steps : kWarps) * kSortCap * 8;
  const size_t left = off < kMaxSmem ? kMaxSmem - off : 0;
  const size_t room = left < budget ? left : budget;
  // a row's bytes in the two buffers and the row table (alignment aside)
  const size_t per_row = p.xstride + (size_t)p.kp * 4 + 3 * 4 + 3 * 8;
  int rows = (int)(room / (2 * per_row));
  rows = rows > kFusedThreads ? kFusedThreads : rows;
  if (rows >= 32) rows &= ~31;
  while (rows > 1 && 2 * buffer_bytes(rows, p.xstride, p.kp, nullptr) + 24 * rows > room)
    --rows;
  p.rows = rows < 1 ? 1 : rows;
  off = align16(off + (size_t)3 * p.rows * 8);
  p.o_region = off;
  p.buf_bytes = buffer_bytes(p.rows, p.xstride, p.kp, &p);
  const size_t stage_bytes = 2 * p.buf_bytes;
  p.total = off + (stage_bytes > sort_bytes ? stage_bytes : sort_bytes);
  return p;
}

// --------------------------------------------------------- selection

// One bin's list in one block of the cluster.
struct BinList {
  const uint16_t* list;             // slot indices of the bin, from `off`
  const unsigned long long* keys;   // the block's per-slot keys
  int off, m;
};

// Calls f(key) on every key of the bin, 32 at a time (one a lane; lanes
// past the end pass kNoKey), the whole warp in step.  Four keys a lane
// are loaded ahead, so the loads' latencies (distributed shared memory
// for another block's list) overlap.
template <typename F>
__device__ inline void for_keys(const BinList* lists, int nlist, F f) {
  constexpr int kAhead = 4;
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nlist; ++r) {
    const BinList b = lists[r];
    for (int base = 0; base < b.m; base += 32 * kAhead) {
      unsigned long long key[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int e = base + u * 32 + lane;
        key[u] = e < b.m ? b.keys[b.list[b.off + e]] : kNoKey;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (base + u * 32 < b.m) f(key[u]);  // warp-uniform
    }
  }
}

// Run by one warp: the ks smallest distinct keys of the bin, ascending,
// to bd/bi; unfilled entries (+inf, fill).  buf: the warp's kSortCap keys.
__device__ void select_bin(const BinList* lists, int nlist, int ks, int fill,
                           unsigned long long* buf, float* __restrict__ bd,
                           int* __restrict__ bi) {
  warp_topk([&](auto f) { for_keys(lists, nlist, f); }, ks, fill, buf, bd, bi);
}

// ----------------------------------------------------------- the body

// kWindow: B1 (slots are rows of the query's S selected blocks of the
// flattened (L*nb) block axis; ids outside [0, lnb) contribute nothing,
// not even to cnt); else B2 (slots are the query's (L, Ct) gathered
// candidates; invalid ones carry +inf projections, so hw = +inf keeps them
// out of every bin).
template <int kMode, bool kWindow>
__device__ inline void search_body(const Args& a) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int qi = blockIdx.x / a.split;
  const int tid = threadIdx.x;
  const int steps = a.steps, K = a.K, d = a.d, B = a.B;

  float* halves = reinterpret_cast<float*>(smem);
  float* sg = reinterpret_cast<float*>(smem + a.o_g);
  float* sq = reinterpret_cast<float*>(smem + a.o_q);
  int* sblk = reinterpret_cast<int*>(smem + a.o_blk);
  int* hist = reinterpret_cast<int*>(smem + a.o_hist);  // all | finite | fill | off
  int* sqp = reinterpret_cast<int*>(smem + a.o_qp);
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem + a.o_key);
  uint16_t* sbin = reinterpret_cast<uint16_t*>(smem + a.o_bin);
  uint16_t* slist = reinterpret_cast<uint16_t*>(smem + a.o_list);
  int64_t* rowtab = reinterpret_cast<int64_t*>(smem + a.o_rows);  // 3 stages of rows
  char* region = smem + a.o_region;

  // this block's share of the query's slots
  int c0, c1;
  if constexpr (kWindow) {
    c0 = (rank * a.S / a.split) * B;
    c1 = ((rank + 1) * a.S / a.split) * B;
  } else {
    c0 = rank * a.C / a.split;
    c1 = (rank + 1) * a.C / a.split;
  }

  // the query: halves, projections, distance operand (the float32 query,
  // or the quantized one widened to 4-byte words), block ids; counts at 0
  stage(halves, a.halves, steps);
  stage(sg, a.g + (int64_t)qi * a.L * K, a.L * K);
  if constexpr (kMode == kBf16) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a.qv) + (int64_t)qi * d;
    for (int i = tid; i < d; i += blockDim.x) sq[i] = __bfloat162float(src[i]);
  } else if constexpr (kMode == kInt8) {
    const int8_t* src = static_cast<const int8_t*>(a.qv) + (int64_t)qi * d;
    int* dst = reinterpret_cast<int*>(sq);
    int8_t* packed = reinterpret_cast<int8_t*>(sqp);
    for (int i = tid; i < d; i += blockDim.x) {
      dst[i] = src[i];
      packed[i] = src[i];
    }
  } else {
    stage(sq, static_cast<const float*>(a.qv) + (int64_t)qi * d, d);
  }
  if constexpr (kWindow) {
    for (int s = tid; s < a.S; s += blockDim.x) sblk[s] = a.blk[(int64_t)qi * a.S + s];
  }
  for (int i = tid; i < 4 * steps; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const float qq = a.q2[qi];
  const float qsc = quantized(kMode) ? a.qs[qi] : 1.0f;
  const int xb = x_bytes(kMode);
  const int rowbytes = d * xb;
  const bool xvec = a.xvec != 0;

  // the device row of slot c, or -1 for a slot of an invalid block
  auto row_of = [&](int c) -> int64_t {
    if constexpr (kWindow) {
      const int s = c / B;
      const int bk = sblk[s];
      return (bk >= 0 && bk < a.lnb) ? (int64_t)bk * B + (c - s * B) : -1;
    } else {
      return (int64_t)qi * a.C + c;
    }
  };

  // ---- phase 1: stage `rows` slots at a time, double-buffered.  The
  // device rows of stage t (-1: a slot of an invalid block) are tabled in
  // rowtab[t % 3] two stages ahead, so the copy loops do no division.
  const int nloc = c1 - c0;
  const int R = a.rows;
  const int nstage = (nloc + R - 1) / R;
  const int nt = blockDim.x;
  auto fill_rows = [&](int t) {
    if (t >= nstage) return;
    const int cb = c0 + t * R;
    const int nr = min(R, c1 - cb);
    for (int i = tid; i < nr; i += nt) rowtab[(t % 3) * R + i] = row_of(cb + i);
  };
  auto issue = [&](int t) {
    char* buf = region + (size_t)(t & 1) * a.buf_bytes;
    const int64_t* rt = rowtab + (t % 3) * R;
    const int nr = min(R, c1 - (c0 + t * R));
    if (xvec) {
      copy_grid(rt, nr, rowbytes >> 4, [&](int64_t row, int i, int j) {
        cp_async16(buf + (size_t)i * a.xstride + j * 16,
                   static_cast<const char*>(a.x) + row * rowbytes + j * 16);
      });
    } else {
      copy_grid(rt, nr, d, [&](int64_t row, int i, int e) {
        char* dst = buf + (size_t)i * a.xstride;
        if constexpr (kMode == kBf16) {
          reinterpret_cast<__nv_bfloat16*>(dst)[e] =
              static_cast<const __nv_bfloat16*>(a.x)[row * d + e];
        } else if constexpr (kMode == kInt8) {
          reinterpret_cast<int8_t*>(dst)[e] = static_cast<const int8_t*>(a.x)[row * d + e];
        } else {
          cp_async4(reinterpret_cast<float*>(dst) + e,
                    static_cast<const float*>(a.x) + row * d + e);
        }
      });
    }
    float* sp = reinterpret_cast<float*>(buf + a.b_proj);
    if (a.pvec) {
      copy_grid(rt, nr, K >> 1, [&](int64_t row, int i, int k) {
        cp_async8(sp + i * a.kp + 2 * k, a.proj + row * K + 2 * k);
      });
    } else {
      copy_grid(rt, nr, K, [&](int64_t row, int i, int k) {
        cp_async4(sp + i * a.kp + k, a.proj + row * K + k);
      });
    }
    for (int i = tid; i < nr; i += nt) {
      const int64_t row = rt[i];
      if (row < 0) continue;
      cp_async4(buf + a.b_nrm + i * 4, a.nrm + row);
      cp_async4(buf + a.b_id + i * 4, a.ids + row);
      if constexpr (quantized(kMode)) cp_async4(buf + a.b_xs + i * 4, a.xs + row);
    }
  };

  fill_rows(0);
  fill_rows(1);
  __syncthreads();
  if (nstage > 0) issue(0);
  cp_async_commit();
  for (int t = 0; t < nstage; ++t) {
    if (t + 1 < nstage) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const char* buf = region + (size_t)(t & 1) * a.buf_bytes;
    const float* sp = reinterpret_cast<const float*>(buf + a.b_proj);
    const int64_t* rt = rowtab + (t % 3) * R;
    const int cb = c0 + t * R;
    const int nr = min(R, c1 - cb);
    for (int i = tid; i < nr; i += nt) {
      const int c = cb + i;
      float dv = INFINITY;
      int iv = a.n;
      int bin = steps;
      if (rt[i] >= 0) {
        const int table = kWindow ? (c / B) / a.M : c / a.Ct;
        const float* p = sp + i * a.kp;
        const float* gq = sg + table * K;
        const float hw = staged_hw(p, a.pvec != 0, gq, K);
        bin = 0;
        for (int j = 0; j < steps; ++j) bin += hw > halves[j];
        if (bin < steps) {
          const float xsv =
              quantized(kMode) ? reinterpret_cast<const float*>(buf + a.b_xs)[i] : 1.0f;
          dv = staged_d2<kMode>(buf + (size_t)i * a.xstride, xvec, sq, sqp, d,
                                reinterpret_cast<const float*>(buf + a.b_nrm)[i], qq, xsv, qsc);
          iv = reinterpret_cast<const int*>(buf + a.b_id)[i];
          atomicAdd(&hist[bin], 1);
          if (dv < INFINITY) atomicAdd(&hist[steps + bin], 1);
        }
      }
      // the slot's key, and the bin whose list takes it (steps: none)
      const int lc = c - c0;
      const bool listed = bin < steps && dv < INFINITY;
      skey[lc] = pair_key(dv, iv);
      sbin[lc] = (uint16_t)(listed ? bin : steps);
    }
    fill_rows(t + 2);
    __syncthreads();
  }

  // ---- bucketing: each bin's slots with a finite d2, in a list
  if (tid == 0) {
    int off = 0;
    for (int j = 0; j < steps; ++j) {
      hist[3 * steps + j] = off;
      off += hist[steps + j];
    }
  }
  __syncthreads();
  for (int lc = tid; lc < nloc; lc += blockDim.x) {
    const int j = sbin[lc];
    if (j < steps) slist[hist[3 * steps + j] + atomicAdd(&hist[2 * steps + j], 1)] = (uint16_t)lc;
  }
  cluster.sync();  // every block's lists are complete and visible

  // ---- selection: warp w of block r takes bins r + split * (w + kWarps i)
  const int warp = tid >> 5;
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(region) + warp * kSortCap;
  const int64_t out = (int64_t)qi * steps;
  for (int j = rank + a.split * warp; j < steps; j += a.split * kWarps) {
    BinList lists[kMaxSplit];
    int total = 0;
    for (int r = 0; r < a.split; ++r) {
      const int* h = cluster.map_shared_rank(hist, r);
      total += h[j];
      lists[r].list = cluster.map_shared_rank(slist, r);
      lists[r].keys = cluster.map_shared_rank(skey, r);
      lists[r].off = h[3 * steps + j];
      lists[r].m = h[steps + j];
    }
    if ((tid & 31) == 0) a.cnt[out + j] = total;
    select_bin(lists, a.split, a.ks, a.n, buf, a.bd + (out + j) * a.ks,
               a.bi + (out + j) * a.ks);
  }
  cluster.sync();  // no block leaves while another reads its lists
}

template <int kMode>
__global__ void __launch_bounds__(kFusedThreads, 2) fused_window_search_kernel(const Args a) {
  search_body<kMode, true>(a);
}

template <int kMode>
__global__ void __launch_bounds__(kFusedThreads, 2) fused_cand_search_kernel(const Args a) {
  search_body<kMode, false>(a);
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

// Fill the plan's fields of `a` and launch `kernel` with `split` blocks a
// query, `cap` slots at most per block.
template <typename Kernel>
int launch(Kernel kernel, Args a, int mode, int Q, int cap, cudaStream_t stream) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const bool once = (int64_t)Q * a.split <= sm_count();
  const Plan p = plan(mode, a.steps, a.L, a.K, a.d, a.S, cap,
                      once ? kStageBudgetOnce : kStageBudget);
  if (p.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.rows = p.rows;
  a.xstride = p.xstride;
  a.pvec = a.K % 2 == 0 && reinterpret_cast<uintptr_t>(a.proj) % 8 == 0;
  a.kp = a.pvec ? a.K : p.kp;
  a.xvec = (a.d * x_bytes(mode)) % 16 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.o_g = (int)p.o_g;
  a.o_q = (int)p.o_q;
  a.o_qp = (int)p.o_qp;
  a.o_blk = (int)p.o_blk;
  a.o_hist = (int)p.o_hist;
  a.o_key = (int)p.o_key;
  a.o_bin = (int)p.o_bin;
  a.o_list = (int)p.o_list;
  a.o_rows = (int)p.o_rows;
  a.o_region = (int)p.o_region;
  a.buf_bytes = (int)p.buf_bytes;
  a.b_proj = (int)p.b_proj;
  a.b_nrm = (int)p.b_nrm;
  a.b_id = (int)p.b_id;
  a.b_xs = (int)p.b_xs;
  const int err = prepare(kernel, p.total);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Q * a.split));
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = p.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of either kernel asks for when it holds
// a query's whole pool of C slots (S: B1's selected blocks, 0 for B2).  A
// launch that splits a query over a cluster asks for less.
size_t fused_search_smem_bytes(int mode, int steps, int L, int K, int d, int C, int S) {
  return plan(mode, steps, L, K, d, S, C, kStageBudgetOnce).total;
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
  Args a = {};
  a.blk = blk;
  a.proj = proj;
  a.x = x;
  a.nrm = nrm;
  a.ids = ids;
  a.xs = xs;
  a.halves = halves;
  a.g = g;
  a.qv = qv;
  a.q2 = q2;
  a.qs = qs;
  a.bd = bd;
  a.bi = bi;
  a.cnt = cnt;
  a.S = S;
  a.M = M;
  a.lnb = lnb;
  a.B = B;
  a.Ct = 1;
  a.C = S * B;
  a.L = L;
  a.K = K;
  a.d = d;
  a.steps = steps;
  a.ks = ks;
  a.n = n;
  a.split = pick_split(Q, S);
  const int cap = ((S + a.split - 1) / a.split) * B;
  return launch(pick(mode, fused_window_search_kernel<kNorm>, fused_window_search_kernel<kExact>,
                     fused_window_search_kernel<kBf16>, fused_window_search_kernel<kInt8>),
                a, mode, Q, cap, stream);
}

int fused_cand_search_launch(const float* cproj, const void* cx, const float* cnrm,
                             const int* cids, const float* halves, const float* g,
                             const void* qv, const float* q2, const float* qs,
                             const float* cscale, float* bd, int* bi, int* cnt, int Q,
                             int L, int Ct, int K, int d, int steps, int ks, int n,
                             int mode, cudaStream_t stream) {
  Args a = {};
  a.proj = cproj;
  a.x = cx;
  a.nrm = cnrm;
  a.ids = cids;
  a.xs = cscale;
  a.halves = halves;
  a.g = g;
  a.qv = qv;
  a.q2 = q2;
  a.qs = qs;
  a.bd = bd;
  a.bi = bi;
  a.cnt = cnt;
  a.S = 0;
  a.M = 1;
  a.B = 1;
  a.Ct = Ct;
  a.C = L * Ct;
  a.L = L;
  a.K = K;
  a.d = d;
  a.steps = steps;
  a.ks = ks;
  a.n = n;
  a.split = pick_split(Q, a.C);
  const int cap = (a.C + a.split - 1) / a.split;
  return launch(pick(mode, fused_cand_search_kernel<kNorm>, fused_cand_search_kernel<kExact>,
                     fused_cand_search_kernel<kBf16>, fused_cand_search_kernel<kInt8>),
                a, mode, Q, cap, stream);
}

}  // extern "C"
