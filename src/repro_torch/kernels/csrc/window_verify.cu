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
// Bound on this card: bytes.  A gather of the selected rows, K + d + 1
// words per row (B6 reads each distinct selected block once: at most
// Q * M = 320 blocks x 64 rows x 75 words, ~6 MB per call at the main
// path, Q = 64, M = 5, B = 64, K = 10, d = 64), plus g, q and the (Q, k)
// outputs: ~2 us at 3.35 TB/s.  The float32 work (3K + 3d per slot, ~4
// Mflop) is far smaller.
//
// Design:
//   * a query runs on a thread-block cluster of `split` blocks (1, 2 or 4:
//     pick_split, the largest with Q * split within the SM count, so 64
//     queries use 128 SMs); block r takes an r-th share of the query's C
//     slots;
//   * the block stages its slots' rows in shared memory, `rows` slots at
//     a time, double-buffered with cp.async, as B1/B2 do: x rows in 16-byte
//     copies where a row is whole 16-byte chunks and the base is aligned
//     (else 4-byte copies), projection rows in 8-byte copies where K is
//     even and the base aligned (else 4-byte), ids in 4-byte copies;
//     neighbouring threads copy neighbouring addresses (a selected STR
//     block is B consecutive rows), and a table of the stage's device rows,
//     filled two stages ahead, spares the copy loops any division.  g and
//     q join the first stage's copies; B6 loads its block ids first, since
//     the rows follow from them.  A slot of an invalid block id (< 0 or
//     >= nb) stages nothing.  The x rows are padded so that threads
//     reading their own rows hit distinct banks;
//   * each thread then takes one staged slot: id < n, hw (staged_hw, the
//     fmaxf(fabsf(p - g)) sequence over k) <= 0.5f * w, and d2
//     (staged_d2<kExact>, the diff form's fmaf chain over i), kept as a 64-bit key ordered as (d2, id), or kNoKey where
//     the slot fails or d2 is not finite.  Every (d2, id) pair is
//     bit-identical to B1/B2's with exact=True and to B4/B5's, so the
//     one-pass search stays bit-equal to this multi-pass oracle;
//   * selection by counting, with every thread of the cluster and no
//     rounds: each block pushes its keys into the others' shared memory
//     (distributed shared memory), so every block holds the query's C
//     keys; a thread ranks each of its block's keys by counting the keys
//     whose d2 is below its own (32-bit compares of the keys' upper
//     halves), and hands a key of rank r < k to block 0 (entry r, and a
//     count for r).  When no two keys share a d2, that rank is the
//     distinct rank and every rank below min(k, D) (D: the finite keys)
//     comes once; block 0 then writes the entries.  Keys that share a d2
//     (equal d2 under two ids, or one point in several slots) share a
//     rank, and block 0 then turns each later copy of a key into kNoKey
//     and ranks its copy of the C keys again by the whole key.  The k
//     smallest distinct pairs are one defined set, so the result does not
//     depend on how the slots were shared out;
//   * a pool too large for counting (cap * C above kCountWork) is
//     selected by lists instead: each warp cuts its share of the keys to
//     its k smallest distinct (warp_smallest), and warp 0 of block 0
//     takes the k smallest distinct of the cluster's lists (warp_topk); a
//     k above 480 takes k argmin rounds over every key of the cluster;
//   * no atomics: outputs are deterministic;
//   * cudaFuncSetAttribute runs once per kernel and shared-memory size
//     (search_common.cuh's prepare), not at every launch;
//   * 64-bit element offsets, any d.

#include <cooperative_groups.h>

#include "search_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dblsh;

constexpr int kWarps = kThreads / 32;
// Bytes of the two stage buffers: a grid that fits the SMs once takes
// large stages (a query's whole share at the main path), a larger grid
// smaller ones, so that three blocks share an SM (the fastest of 48, 64,
// 96 and 160 KB at Q = 1024 on an H100).
constexpr size_t kStageBudgetOnce = 160 * 1024;
constexpr size_t kStageBudget = 64 * 1024;
// A block ranks its keys by counting (cap keys against all C) while
// cap * C stays within this; a larger pool takes the warps' lists.  The
// main path's 64 queries (160 x 320) count; at 1024 queries (320 x 320,
// one block a query) the lists are faster on an H100.
constexpr int64_t kCountWork = 1 << 16;

__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct VerifyArgs {
  const int* blk;  // B6: (Q, M) block ids
  const float* proj;
  const float* x;
  const int* ids;
  const float* g;  // (Q, K)
  const float* q;  // (Q, d)
  float* bd;
  int* bi;
  float w;
  int M, nb, B;  // B6: slot c is row c % B of block blk[qi, c / B]
  int C, K, d, k, n;
  int split;    // blocks per query (the cluster's size)
  int rows;     // slots per stage buffer
  int xstride;  // bytes per staged x row
  int kp;       // floats per staged projection row
  int xvec;     // x rows staged in 16-byte copies
  int pvec;     // projection rows staged in 8-byte copies
  // byte offsets into the dynamic shared memory (g at 0), and within a
  // stage buffer (x rows at 0)
  int o_q, o_blk, o_sum, o_cnt, o_out, o_hi, o_key, o_rows, o_region, buf_bytes, b_proj, b_id;
};

// The shared-memory plan of one block for a share of `cap` slots.
struct Plan {
  int rows, xstride, kp;
  size_t o_q, o_blk, o_sum, o_cnt, o_out, o_hi, o_key, o_rows, o_region, buf_bytes, b_proj, b_id,
      total;
};

size_t buffer_bytes(int rows, int xstride, int kp, Plan* p) {
  size_t off = align16((size_t)rows * xstride);
  if (p) p->b_proj = off;
  off = align16(off + (size_t)rows * kp * 4);
  if (p) p->b_id = off;
  return align16(off + (size_t)rows * 4);
}

// Counting gives each thread at most one key of the block's share.
bool counted(int cap, int C) { return cap <= kThreads && (int64_t)cap * C <= kCountWork; }

// Keys a block keeps: counting, every slot of the query; else one a slot
// of its share, and room for its warps' k-key lists.
int key_slots(int cap, int C, int k) {
  if (counted(cap, C)) return C;
  return k <= kMaxBufferedKs && kWarps * k > cap ? kWarps * k : cap;
}

// M: B6's blocks per query (0 for B7); cap: slots of the block's share.
// The two stage buffers take at most `budget` bytes; after staging, the
// same region holds the warps' selection buffers.
Plan plan(int K, int d, int M, int C, int cap, int k, size_t budget) {
  Plan p;
  p.xstride = padded_stride(4 * d);
  p.kp = K | 1;  // the 4-byte path's odd stride; the 8-byte path's K is smaller
  size_t off = align16((size_t)K * 4);
  p.o_q = off;
  off = align16(off + (size_t)d * 4);
  p.o_blk = off;
  off = align16(off + (size_t)M * 4);
  p.o_sum = off;  // two block sums
  off = align16(off + 2 * 4);
  // counting: block 0 collects the keys ranked below k, and a count a rank
  const size_t nout = counted(cap, C) ? (size_t)(k < C ? k : C) : 0;
  p.o_cnt = off;
  off = align16(off + nout * 4);
  p.o_out = off;
  off = align16(off + nout * 8);
  p.o_hi = off;  // counting: the keys' d2 halves
  off = align16(off + (counted(cap, C) ? (size_t)C * 4 : 0));
  p.o_key = off;
  off = align16(off + (size_t)key_slots(cap, C, k) * 8);
  p.o_rows = off;  // the row table, 3 stages of rows (sized below)
  const size_t sort_bytes = (size_t)kWarps * kSortCap * 8;
  const size_t left = off < kMaxSmem ? kMaxSmem - off : 0;
  const size_t room = left < budget ? left : budget;
  // a row's bytes in the two buffers and the row table (alignment aside)
  const size_t per_row = p.xstride + (size_t)p.kp * 4 + 4 + 3 * 8;
  int rows = (int)(room / (2 * per_row));
  rows = rows > kThreads ? kThreads : rows;
  if (rows >= cap) {
    rows = cap;
  } else if (rows >= 32) {
    rows &= ~31;
  }
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

// The number of the C values v below x: four 16-byte reads in flight.
__device__ inline int count_below(const unsigned* v, int C, unsigned x) {
  int lt = 0, j = 0;
  for (; j + 16 <= C; j += 16) {
    uint4 y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = *reinterpret_cast<const uint4*>(v + j + 4 * u);
#pragma unroll
    for (int u = 0; u < 4; ++u) lt += (y[u].x < x) + (y[u].y < x) + (y[u].z < x) + (y[u].w < x);
  }
  for (; j < C; ++j) lt += v[j] < x;
  return lt;
}

// kWindow: B6 (slot c of query qi is row c % B of block blk[qi, c / B];
// a block id outside [0, nb) contributes nothing); else B7 (slot c is row
// qi * C + c of the gathered candidates).
//
// kCount: select by counting (else by the warps' lists), a kernel each so
// that each holds only its own selection's code.
template <bool kWindow, bool kCount>
__device__ inline void verify_body(const VerifyArgs& a) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster_arrive_relaxed();  // waited for before the first access to another block
  const int qi = blockIdx.x / a.split;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = a.K, d = a.d, B = a.B, C = a.C, k = a.k;

  float* sg = reinterpret_cast<float*>(smem);
  float* sq = reinterpret_cast<float*>(smem + a.o_q);
  int* sblk = reinterpret_cast<int*>(smem + a.o_blk);
  int* ssum = reinterpret_cast<int*>(smem + a.o_sum);
  int* scnt = reinterpret_cast<int*>(smem + a.o_cnt);
  unsigned long long* sout = reinterpret_cast<unsigned long long*>(smem + a.o_out);
  unsigned* shi = reinterpret_cast<unsigned*>(smem + a.o_hi);
  // counting: the query's C keys in slot order; else the block's own, from 0
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem + a.o_key);
  int64_t* rowtab = reinterpret_cast<int64_t*>(smem + a.o_rows);  // 3 stages of rows
  char* region = smem + a.o_region;

  // this block's share of the query's slots
  const int c0 = rank * C / a.split;
  const int c1 = (rank + 1) * C / a.split;
  const int koff = kCount ? 0 : c0;  // skey index of slot c: c - koff

  if constexpr (kWindow) {  // the block ids first: the rows to copy follow from them
    for (int m = tid; m < a.M; m += nt) sblk[m] = a.blk[(int64_t)qi * a.M + m];
    __syncthreads();
  }
  // g and q join the first stage's copies
  for (int i = tid; i < K; i += nt) cp_async4(sg + i, a.g + (int64_t)qi * K + i);
  for (int i = tid; i < d; i += nt) cp_async4(sq + i, a.q + (int64_t)qi * d + i);

  // the device row of slot c, or -1 for a slot of an invalid block
  auto row_of = [&](int c) -> int64_t {
    if constexpr (kWindow) {
      const int m = c / B;
      const int bk = sblk[m];
      return (bk >= 0 && bk < a.nb) ? (int64_t)bk * B + (c - m * B) : -1;
    } else {
      return (int64_t)qi * C + c;
    }
  };

  // ---- stage `rows` slots at a time, double-buffered.  The device rows
  // of stage t are tabled in rowtab[t % 3] two stages ahead.
  const int nloc = c1 - c0;
  const int R = a.rows;
  const int nstage = (nloc + R - 1) / R;
  const int rowbytes = 4 * d;
  const bool xvec = a.xvec != 0, pvec = a.pvec != 0;
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
                   reinterpret_cast<const char*>(a.x) + row * rowbytes + j * 16);
      });
    } else {
      copy_grid(rt, nr, d, [&](int64_t row, int i, int e) {
        cp_async4(reinterpret_cast<float*>(buf + (size_t)i * a.xstride) + e, a.x + row * d + e);
      });
    }
    float* sp = reinterpret_cast<float*>(buf + a.b_proj);
    if (pvec) {
      copy_grid(rt, nr, K >> 1, [&](int64_t row, int i, int u) {
        cp_async8(sp + i * a.kp + 2 * u, a.proj + row * K + 2 * u);
      });
    } else {
      copy_grid(rt, nr, K, [&](int64_t row, int i, int u) {
        cp_async4(sp + i * a.kp + u, a.proj + row * K + u);
      });
    }
    int* sid = reinterpret_cast<int*>(buf + a.b_id);
    for (int i = tid; i < nr; i += nt) {
      const int64_t row = rt[i];
      if (row >= 0) cp_async4(sid + i, a.ids + row);
    }
  };

  const float half = 0.5f * a.w;
  if (tid < 2) ssum[tid] = 0;
  if constexpr (kCount) {
    for (int r = tid; r < min(k, C); r += nt) scnt[r] = 0;
  }
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
    const int* sid = reinterpret_cast<const int*>(buf + a.b_id);
    const int64_t* rt = rowtab + (t % 3) * R;
    const int cb = c0 + t * R;
    const int nr = min(R, c1 - cb);
    for (int i = tid; i < nr; i += nt) {
      unsigned long long key = kNoKey;
      if (rt[i] >= 0) {
        const int iv = sid[i];
        if (iv < a.n && staged_hw(sp + i * a.kp, pvec, sg, K) <= half) {
          const float dv = staged_d2<kExact>(buf + (size_t)i * a.xstride, xvec, sq, nullptr,
                                             d, 0.0f, 0.0f, 0.0f, 0.0f);
          if (dv < INFINITY) key = pair_key(dv, iv);
        }
      }
      skey[cb - koff + i] = key;
      if constexpr (kCount) shi[cb + i] = (unsigned)(key >> 32);
    }
    fill_rows(t + 2);
    __syncthreads();
  }

  cluster_wait();  // every block of the cluster has started
  const int64_t out = (int64_t)qi * k;
  if constexpr (kCount) {
    // ---- selection by counting (the design notes above): push the keys,
    // rank this block's by their d2 halves, hand ranks below k to block 0
    for (int r = 0; r < a.split; ++r) {
      if (r == rank) continue;
      unsigned long long* dk = cluster.map_shared_rank(skey, r);
      unsigned* dh = cluster.map_shared_rank(shi, r);
      for (int c = c0 + tid; c < c1; c += nt) {
        dk[c] = skey[c];
        dh[c] = shi[c];
      }
    }
    cluster.sync();  // every block holds the query's C keys
    const unsigned long long x = tid < nloc ? skey[c0 + tid] : kNoKey;  // counted(): one
    if (x < kNoKey) {
      const int lt = count_below(shi, C, (unsigned)(x >> 32));
      if (lt < k) {
        cluster.map_shared_rank(sout, 0)[lt] = x;
        atomicAdd(cluster.map_shared_rank(scnt, 0) + lt, 1);
      }
    }
    cluster.sync();  // block 0 holds the keys ranked below k
    if (rank != 0) return;

    // the sum over the block of each thread's v, in ssum[slot]
    auto block_sum = [&](int v, int slot) {
      v = __reduce_add_sync(kFullMask, v);
      if ((tid & 31) == 0) atomicAdd(&ssum[slot], v);
      __syncthreads();
      return ssum[slot];
    };
    auto finite = [&]() {
      int f = 0;
      for (int j = tid; j < C; j += nt) f += skey[j] < kNoKey;
      return block_sum(f, 0);
    };
    int D = min(finite(), k);
    bool once = true;
    for (int r = tid; r < D; r += nt) once &= scnt[r] == 1;
    if (__syncthreads_and(once)) {
      for (int r = tid; r < D; r += nt) {
        a.bd[out + r] = key_d2(sout[r]);
        a.bi[out + r] = key_id(sout[r]);
      }
    } else {
      // every later copy of a key becomes kNoKey, then every key is ranked
      unsigned later = 0;  // bit m: this thread's m-th slot (C <= 32 * nt)
      for (int j = tid, m = 0; j < C; j += nt, ++m) {
        const unsigned long long y = skey[j];
        if (y == kNoKey) continue;
        for (int i = 0; i < j; ++i) {
          if (skey[i] == y) {
            later |= 1u << m;
            break;
          }
        }
      }
      __syncthreads();
      for (int j = tid, m = 0; j < C; j += nt, ++m)
        if ((later >> m) & 1u) skey[j] = kNoKey;
      __syncthreads();
      int f = 0;
      for (int j = tid; j < C; j += nt) {
        const unsigned long long y = skey[j];
        if (y == kNoKey) continue;
        ++f;
        int r = 0;
        for (int i = 0; i < C; ++i) r += skey[i] < y;
        if (r < k) {
          a.bd[out + r] = key_d2(y);
          a.bi[out + r] = key_id(y);
        }
      }
      D = min(block_sum(f, 1), k);
    }
    for (int r = D + tid; r < k; r += nt) {
      a.bd[out + r] = INFINITY;
      a.bi[out + r] = a.n;
    }
  } else {
    // ---- selection by lists: each warp's k smallest distinct keys of its
    // share, as a k-key list in skey; then warp 0 of block 0 over the
    // cluster's lists
    const int warp = tid >> 5, lane = tid & 31;
    const bool listed = k <= kMaxBufferedKs;
    unsigned long long* wbuf = reinterpret_cast<unsigned long long*>(region) + warp * kSortCap;
    if (listed) {
      const int w0 = warp * nloc / kWarps, w1 = (warp + 1) * nloc / kWarps;
      const int ntop = warp_smallest(
          [&](auto f) { for_flat_keys(skey + w0, w1 - w0, f); }, k, wbuf);
      __syncthreads();  // every warp has read its share of the keys
      for (int r = lane; r < k; r += 32) skey[warp * k + r] = r < ntop ? wbuf[r] : kNoKey;
    }
    cluster.sync();  // every block's lists (or keys) are complete and visible
    if (rank == 0 && warp == 0) {
      warp_topk(
          [&](auto f) {
            for (int r = 0; r < a.split; ++r) {
              const int m = listed ? kWarps * k : (r + 1) * C / a.split - r * C / a.split;
              for_flat_keys(cluster.map_shared_rank(skey, r), m, f);
            }
          },
          k, a.n, wbuf, a.bd + out, a.bi + out);
    }
    cluster.sync();  // no block leaves while block 0 reads its keys
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads) window_verify_kernel(const VerifyArgs a) {
  verify_body<true, kCount>(a);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads) candidate_verify_kernel(const VerifyArgs a) {
  verify_body<false, kCount>(a);
}

// Fill the plan's fields of `a` and launch B6 (window) or B7 on `split`
// blocks a query.
int launch(bool window, VerifyArgs a, int Q, cudaStream_t stream) {
  a.split = pick_split(Q, a.C);
  const int cap = (a.C + a.split - 1) / a.split;
  const bool once = (int64_t)Q * a.split <= sm_count();
  const Plan p = plan(a.K, a.d, window ? a.M : 0, a.C, cap, a.k,
                      once ? kStageBudgetOnce : kStageBudget);
  if (p.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.rows = p.rows;
  a.xstride = p.xstride;
  a.pvec = a.K % 2 == 0 && reinterpret_cast<uintptr_t>(a.proj) % 8 == 0;
  a.kp = a.pvec ? a.K : p.kp;
  a.xvec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.o_q = (int)p.o_q;
  a.o_blk = (int)p.o_blk;
  a.o_sum = (int)p.o_sum;
  a.o_cnt = (int)p.o_cnt;
  a.o_out = (int)p.o_out;
  a.o_hi = (int)p.o_hi;
  a.o_key = (int)p.o_key;
  a.o_rows = (int)p.o_rows;
  a.o_region = (int)p.o_region;
  a.buf_bytes = (int)p.buf_bytes;
  a.b_proj = (int)p.b_proj;
  a.b_id = (int)p.b_id;
  const bool count = counted(cap, a.C);
  void (*kernel)(const VerifyArgs) =
      window ? (count ? window_verify_kernel<true> : window_verify_kernel<false>)
             : (count ? candidate_verify_kernel<true> : candidate_verify_kernel<false>);
  const int err = prepare(kernel, p.total);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Q * a.split));
  cfg.blockDim = dim3(kThreads);
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

// Dynamic shared memory one block of either verify kernel asks for when it
// holds a query's whole pool of C slots (M: B6's blocks per query, 0 for
// B7).  A launch that splits a query over a cluster asks for less.
size_t verify_smem_bytes(int K, int d, int C, int M, int k) {
  return plan(K, d, M, C, C, k, kStageBudgetOnce).total;
}

// Returns a cudaError_t (0 = launched).  Launches on `stream`, no sync.
int window_verify_launch(const int* blk, const float* proj, const float* x, const int* ids,
                         const float* g, const float* q, float w, float* bd, int* bi,
                         int Q, int M, int nb, int B, int K, int d, int k, int n,
                         cudaStream_t stream) {
  VerifyArgs a = {};
  a.blk = blk;
  a.proj = proj;
  a.x = x;
  a.ids = ids;
  a.g = g;
  a.q = q;
  a.bd = bd;
  a.bi = bi;
  a.w = w;
  a.M = M;
  a.nb = nb;
  a.B = B;
  a.C = M * B;
  a.K = K;
  a.d = d;
  a.k = k;
  a.n = n;
  return launch(true, a, Q, stream);
}

int candidate_verify_launch(const float* cproj, const float* cx, const int* cids,
                            const float* g, const float* q, float w, float* bd, int* bi,
                            int Q, int C, int K, int d, int k, int n, cudaStream_t stream) {
  VerifyArgs a = {};
  a.proj = cproj;
  a.x = cx;
  a.ids = cids;
  a.g = g;
  a.q = q;
  a.bd = bd;
  a.bi = bi;
  a.w = w;
  a.M = 1;
  a.B = 1;
  a.C = C;
  a.K = K;
  a.d = d;
  a.k = k;
  a.n = n;
  return launch(false, a, Q, stream);
}

}  // extern "C"
