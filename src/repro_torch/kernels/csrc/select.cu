// Block selection for Hopper (sm_90a): kernel S1, the selection stage of the
// port's search (repro_torch.core.serve_search._select_blocks, wrapper
// repro_torch/kernels/ops.py select_blocks).
//
// Replaces no Pallas kernel: the JAX package selects with jnp and
// lax.top_k (repro/core/serve_search.py:161-190).  The same selection in
// eager PyTorch built three (Q, nb, K) temporaries a table (1.6 GB each at
// Q = 256, nb = 156,250, K = 10) and sorted every table's (Q, nb) scores in
// full to keep M of them: ~400x over the bound below.
//
// What it computes (twin: repro_torch/kernels/ref.py select_blocks_ref, the
// eager code it replaced), for each table l and query q, with half the
// float32 half width and every sum rounded to float32:
//   * block b overlaps when mbr_lo[l,b,k] <= g[q,l,k] + half and
//     mbr_hi[l,b,k] >= g[q,l,k] - half for every k;
//   * pd_k = max(lo - g, 0) + max(g - hi, 0), MINDIST the sum of pd_k^2,
//     each square and sum an explicitly rounded intrinsic (__fmul_rn,
//     __fadd_rn: nothing is contracted into an fma), in torch's order below;
//   * the M smallest keys (score bits << 32) | b, score MINDIST for an
//     overlapping block and +inf otherwise: scores are >= 0 or +inf, so
//     their bits order as the floats, and the keys give the first M of
//     torch's stable ascending sort, ties to the lowest block index;
//   * blk[l,q,m] = b and bhw[l,q,m] = max_k pd_k where the selected block
//     overlaps; nb and +inf where it does not.
//
// MINDIST's order is that of torch's CUDA sum over a contiguous last
// dimension (ATen/native/cuda/Reduce.cuh as installed with torch 2.11, the
// card's): below K = 128 no input vectorisation; block width bw =
// min(last_pow2(K), 32); lane x < bw adds elements x + bw t into
// accumulator t mod 4 (vt0 = 4), in t order, from 0; the accumulators
// combine as ((a0 + a1) + a2) + a3; the lanes combine by shfl_down at
// offsets bw/2, bw/4, ..., 1 (lane x adds lane x + o).  So S1 is bit-equal
// to the twin on the card for K < 128 (for 64 <= K < 128 while Q nb >= 16:
// below that torch's block widens past a warp).  At K >= 128 torch
// vectorises its loads; S1 keeps the scheme above at bw = 32, its own fixed
// order, within float32 rounding of torch's.
//
// Bound on this card: operations.  Every (query, table, block) pair is
// tested: two compares a dimension, and the MINDIST (~6 operations a
// dimension) only where the box overlaps; ~8 operations a (q, l, b, k) at
// 67 TFLOP/s is 0.24 ms at Q = 256, L = 5, nb = 156,250, K = 10.  The MBRs
// (62.5 MB there), read once a query tile, take ~0.04 ms at 3.35 TB/s.
//
// Design (the path follows K and M):
//   * K < 32 and M <= kThreadMaxM (the thread path; every index of the
//     benchmark): a thread
//     holds one query's g - half, g + half and g in registers, padded to
//     KP, the next multiple of 4 (pads -inf, +inf and 0, beside MBR pads of
//     0: a pad passes the test and adds an exact 0 to MINDIST); the kernel
//     is instantiated per (bw, KP), so MINDIST's tree is unrolled;
//   * a block of 128 threads takes QT queries of one table (the next power
//     of two of Q, at most 128) and a chunk of its blocks; BL = 128 / QT
//     threads share a query and take every BL-th block of a stage;
//   * the chunk's MBR rows pass through a two-stage ring in shared memory
//     (cp.async), kStage blocks a stage, a row as KP floats of lo then KP
//     of hi, read 16 bytes at a time; with QT >= 32 a warp reads one row
//     (a broadcast);
//   * a pair is tested first and its MINDIST computed only if it overlaps;
//     its key enters the thread's list (M keys, ascending, in shared
//     memory) only when below the list's last, held in a register: after
//     the first blocks, rarely;
//   * K >= 32 or M > kThreadMaxM (the warp path: the LM datastores,
//     K = 2,308-3,077, and any M up to nb): a warp takes one query, its
//     lanes the dimensions, 32 at a time, read from device memory
//     (coalesced; the block's four warps take four queries over the same
//     rows, so L1 serves most reads); a block is dropped at the first 32
//     dimensions where a lane fails; the warp's list is its chunk's row of
//     scratch, so M is bounded by nothing on the card.  Below K = 32 its
//     sum is torch's too: lanes past K add exact zeros until the shuffle at
//     offset bw, where lane x < bw adds lane x + bw as torch's two
//     accumulators do, and the tree below is torch's;
//   * chunks: as many as give ~8 blocks an SM over (query tile, chunk,
//     table), at most kMaxChunks and at least one stage of blocks each
//     (on the warp path max(8, M) blocks, so scratch stays within L Q nb
//     keys); each block writes the M smallest keys of its chunk a query to
//     scratch (threads that share a query merge their lists first); a
//     second launch, select_merge_kernel, a warp a (table, query), merges
//     the chunks' lists (a tournament of 32 lanes, one list advanced a
//     round) and tests each chosen block again as it comes, writing blk
//     and bhw;
//   * no atomics: outputs are deterministic.

#include <algorithm>

#include "search_common.cuh"

namespace {

using dblsh::kFullMask;
using dblsh::kNoKey;
typedef unsigned long long u64;

constexpr int kSelThreads = 128;      // threads of a scan or merge block
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kStage = 64;            // MBR rows a stage of the ring (thread path)
constexpr int kWarpChunk = 8;         // fewest blocks a chunk (warp path)
constexpr int kThreadMaxM = 64;       // longest list a thread keeps in shared memory
constexpr int kMaxChunks = 256;       // lists a merge takes: 8 a lane
constexpr int kChunkLanes = kMaxChunks / 32;
constexpr int kChunksPerSm = 8;       // scan blocks an SM the chunking aims at
constexpr unsigned kInfBits = 0x7f800000u;

struct SelArgs {
  const float* lo;   // (L, nb, K)
  const float* hi;   // (L, nb, K)
  const float* g;    // (Q, L, K)
  u64* part;         // (L, Q, nchunk, M) keys, kNoKey past a list's end
  int* blk;          // (L, Q, M)
  float* bhw;        // (L, Q, M)
  float half;
  int Q, L, nb, K, M;
  int qt, nchunk, chunk;
};

struct Plan {
  bool warp;  // K >= 32 or M > kThreadMaxM: a warp a query
  int qt;     // queries a scan block
  int nqt;    // query tiles
  int nchunk;
  int chunk;  // blocks a chunk
};

// The box distance of one dimension, as the twin's
// clamp(lo - g, min=0) + clamp(g - hi, min=0).
__device__ inline float box_pd(float lo, float hi, float g) {
  const float a = __fsub_rn(lo, g), b = __fsub_rn(g, hi);
  return __fadd_rn(a > 0.f ? a : 0.f, b > 0.f ? b : 0.f);
}

// Insert `key` into an ascending list of M keys held `stride` keys apart;
// returns the list's new last key.
__device__ inline u64 list_insert(u64* lst, int stride, int M, u64 key) {
  int j = M - 1;
  while (j > 0) {
    const u64 prev = lst[(j - 1) * stride];
    if (prev < key) break;
    lst[j * stride] = prev;
    --j;
  }
  lst[j * stride] = key;
  return lst[(M - 1) * stride];
}

// The whole warp: the M smallest keys of `nl` ascending lists of M keys
// (list j's key i at lists[j * list_stride + i * key_stride]), ascending,
// each passed to emit(m, key) by the whole warp as it is found (kNoKey past
// the last).  Lane x holds the heads of lists x, x + 32, ...; each round
// takes the warp's smallest head and advances the one list that held it
// (the keys of a table and query are distinct: each names its block).
template <int LPL, typename Emit>
__device__ void warp_merge(const u64* lists, int64_t list_stride, int64_t key_stride, int nl,
                           int M, Emit emit) {
  const int lane = threadIdx.x & 31;
  u64 head[LPL];
  int cur[LPL];
#pragma unroll
  for (int i = 0; i < LPL; ++i) {
    const int j = lane + 32 * i;
    cur[i] = 0;
    head[i] = j < nl ? lists[j * list_stride] : kNoKey;
  }
  for (int m = 0; m < M; ++m) {
    u64 best = kNoKey;
#pragma unroll
    for (int i = 0; i < LPL; ++i) best = head[i] < best ? head[i] : best;
    const u64 win = dblsh::warp_min_key(best);
    if (win == kNoKey) {
      for (int r = m; r < M; ++r) emit(r, kNoKey);
      return;
    }
    emit(m, win);
#pragma unroll
    for (int i = 0; i < LPL; ++i) {
      if (head[i] == win) {
        const int64_t j = lane + 32 * i;
        head[i] = ++cur[i] < M ? lists[j * list_stride + cur[i] * key_stride] : kNoKey;
      }
    }
  }
}

// MINDIST of one staged row (KP floats of lo, then KP of hi) against g, in
// torch's order for a block width of BW (the file's header): lane x's two
// elements x and x + BW (a pad or an absent element adds an exact 0), then
// the tree at offsets BW/2, ..., 1.
template <int BW, int KP>
__device__ inline float staged_mindist(const float* row, const float (&gq)[KP]) {
  float v[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const float pd = box_pd(row[k], row[KP + k], gq[k]);
    v[k] = __fmul_rn(pd, pd);
  }
  float s[BW];
#pragma unroll
  for (int x = 0; x < BW; ++x) s[x] = x + BW < KP ? __fadd_rn(v[x], v[x + BW]) : v[x];
#pragma unroll
  for (int o = BW / 2; o > 0; o /= 2) {
#pragma unroll
    for (int x = 0; x < o; ++x) s[x] = __fadd_rn(s[x], s[x + o]);
  }
  return s[0];
}

// The thread path (K < 32, M <= kThreadMaxM).  Grid: (query tiles, chunks, tables).
template <int BW, int KP>
__global__ void __launch_bounds__(kSelThreads) select_scan_kernel(SelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRow = 2 * KP;  // floats a staged row
  float* ring = reinterpret_cast<float*>(smem);
  u64* lists = reinterpret_cast<u64*>(ring + 2 * kStage * kRow);  // key m of thread t at m * 128 + t
  const int tid = threadIdx.x, K = a.K, M = a.M;
  const int QT = a.qt, BL = kSelThreads / QT;
  const int qi = tid & (QT - 1), bl = tid / QT;
  const int l = blockIdx.z, chunk = blockIdx.y;
  const int q = blockIdx.x * QT + qi;
  const bool live = q < a.Q;
  const int b0 = chunk * a.chunk, b1 = min(a.nb, b0 + a.chunk);

  float gm[KP], gp[KP], gq[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const float v = live && k < K ? a.g[((int64_t)q * a.L + l) * K + k] : 0.f;
    gq[k] = v;
    gm[k] = k < K ? __fsub_rn(v, a.half) : -INFINITY;
    gp[k] = k < K ? __fadd_rn(v, a.half) : INFINITY;
  }
  // the rows' pads stay 0: cp.async writes only k < K.  A row is two
  // halves of KP floats (lo, hi), each with KP - K pads.
  const int pads = KP - K;
  for (int i = tid; i < 2 * kStage * 2 * pads; i += kSelThreads) {
    const int h = i / pads;
    ring[h * KP + K + (i - h * pads)] = 0.f;
  }
  for (int m = 0; m < M; ++m) lists[m * kSelThreads + tid] = kNoKey;

  const float* lo = a.lo + (int64_t)l * a.nb * K;
  const float* hi = a.hi + (int64_t)l * a.nb * K;
  // this thread's share of copying stage rows [t0, t0 + nt): neighbouring
  // threads copy neighbouring words; (j, k) advance with no division
  const int dj = kSelThreads / K, dk = kSelThreads - dj * K;
  auto issue = [&](int t0, float* dst) {
    const int cnt = min(kStage, b1 - t0) * K;
    const float* sl = lo + (int64_t)t0 * K;
    const float* sh = hi + (int64_t)t0 * K;
    int j = tid / K, k = tid - j * K;
    for (int e = tid; e < cnt; e += kSelThreads) {
      dblsh::cp_async4(dst + j * kRow + k, sl + e);
      dblsh::cp_async4(dst + j * kRow + KP + k, sh + e);
      j += dj;
      k += dk;
      if (k >= K) {
        k -= K;
        ++j;
      }
    }
  };

  const int ntiles = (b1 - b0 + kStage - 1) / kStage;
  issue(b0, ring);
  dblsh::cp_async_commit();
  u64 worst = kNoKey;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) issue(b0 + (t + 1) * kStage, ring + ((t + 1) & 1) * kStage * kRow);
    dblsh::cp_async_commit();
    dblsh::cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const float* st = ring + (t & 1) * kStage * kRow;
      const int t0 = b0 + t * kStage, nt = min(kStage, b1 - t0);
      for (int j = bl; j < nt; j += BL) {
        const float* row = st + j * kRow;
        const float4* row4 = reinterpret_cast<const float4*>(row);
        bool ok = true;
#pragma unroll
        for (int c = 0; c < KP / 4; ++c) {
          const float4 l4 = row4[c], h4 = row4[KP / 4 + c];
          ok &= (l4.x <= gp[4 * c]) & (l4.y <= gp[4 * c + 1]) & (l4.z <= gp[4 * c + 2]) &
                (l4.w <= gp[4 * c + 3]) & (h4.x >= gm[4 * c]) & (h4.y >= gm[4 * c + 1]) &
                (h4.z >= gm[4 * c + 2]) & (h4.w >= gm[4 * c + 3]);
        }
        unsigned bits = kInfBits;
        if (ok) bits = __float_as_uint(staged_mindist<BW, KP>(row, gq));
        const u64 key = ((u64)bits << 32) | (unsigned)(t0 + j);
        if (key < worst) worst = list_insert(lists + tid, kSelThreads, M, key);
      }
    }
    __syncthreads();
  }

  const int64_t out_row = (int64_t)l * a.Q;
  if (BL == 1) {
    if (live) {
      u64* out = a.part + ((out_row + q) * a.nchunk + chunk) * M;
      for (int m = 0; m < M; ++m) out[m] = lists[m * kSelThreads + tid];
    }
    return;
  }
  // threads qi, qi + QT, ... share query qi: warp w merges queries w, w + 4, ...
  const int warp = tid >> 5, lane = tid & 31;
  for (int qj = warp; qj < QT; qj += kSelWarps) {
    const int qq = blockIdx.x * QT + qj;
    if (qq >= a.Q) break;
    u64* out = a.part + ((out_row + qq) * a.nchunk + chunk) * M;
    warp_merge<kSelThreads / 32>(lists + qj, QT, kSelThreads, BL, M, [&](int m, u64 key) {
      if (lane == 0) out[m] = key;
    });
  }
}

// The warp path (K >= 32 or M > kThreadMaxM).  Grid: (query tiles of 4,
// chunks, tables).
__global__ void __launch_bounds__(kSelThreads) select_scan_warp_kernel(SelArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = a.K, M = a.M;
  const int l = blockIdx.z, chunk = blockIdx.y;
  const int q = blockIdx.x * kSelWarps + warp;
  if (q >= a.Q) return;  // the block has no barrier
  // the list lives in its chunk's row of scratch, which it leaves as output
  // (lane 0 writes it; __syncwarp orders that before the other lanes' reads)
  u64* lst = a.part + (((int64_t)l * a.Q + q) * a.nchunk + chunk) * M;
  for (int m = lane; m < M; m += 32) lst[m] = kNoKey;
  __syncwarp();
  const int b0 = chunk * a.chunk, b1 = min(a.nb, b0 + a.chunk);
  const float* gq = a.g + ((int64_t)q * a.L + l) * K;
  u64 worst = kNoKey;
  for (int b = b0; b < b1; ++b) {
    const float* lo = a.lo + ((int64_t)l * a.nb + b) * K;
    const float* hi = a.hi + ((int64_t)l * a.nb + b) * K;
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    bool ok = true;
    for (int k0 = 0, t = 0; k0 < K; k0 += 32, ++t) {
      const int k = k0 + lane;
      float v = 0.f;
      bool lane_ok = true;
      if (k < K) {
        const float gv = __ldg(gq + k), lv = __ldg(lo + k), hv = __ldg(hi + k);
        lane_ok = (lv <= __fadd_rn(gv, a.half)) & (hv >= __fsub_rn(gv, a.half));
        const float pd = box_pd(lv, hv, gv);
        v = __fmul_rn(pd, pd);
      }
      if (!__all_sync(kFullMask, lane_ok)) {
        ok = false;
        break;
      }
      switch (t & 3) {
        case 0: acc0 = __fadd_rn(acc0, v); break;
        case 1: acc1 = __fadd_rn(acc1, v); break;
        case 2: acc2 = __fadd_rn(acc2, v); break;
        default: acc3 = __fadd_rn(acc3, v); break;
      }
    }
    unsigned bits = kInfBits;
    if (ok) {
      float s = __fadd_rn(__fadd_rn(__fadd_rn(acc0, acc1), acc2), acc3);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(kFullMask, s, o));
      bits = __float_as_uint(__shfl_sync(kFullMask, s, 0));
    }
    const u64 key = ((u64)bits << 32) | (unsigned)b;
    if (key < worst) {  // the same on every lane
      if (lane == 0) list_insert(lst, 1, M, key);
      __syncwarp();
      worst = lst[M - 1];
    }
  }
}

// A warp a (table, query): the chunks' lists merged, each chosen block
// tested again as it comes, blk and bhw written.  Grid: ceil(L Q / 4) blocks.
__global__ void __launch_bounds__(kSelThreads) select_merge_kernel(SelArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kSelWarps + warp;  // l * Q + q
  if (r >= (int64_t)a.L * a.Q) return;  // the block has no barrier
  const int K = a.K, M = a.M;
  const int l = (int)(r / a.Q), q = (int)(r - (int64_t)l * a.Q);
  const float* gq = a.g + ((int64_t)q * a.L + l) * K;
  warp_merge<kChunkLanes>(a.part + r * a.nchunk * M, M, 1, a.nchunk, M, [&](int m, u64 key) {
    const int b = (int)(unsigned)key;
    bool ok = key != kNoKey;
    float mx = 0.f;
    if (ok) {
      const float* lo = a.lo + ((int64_t)l * a.nb + b) * K;
      const float* hi = a.hi + ((int64_t)l * a.nb + b) * K;
      bool lane_ok = true;
      for (int k = lane; k < K; k += 32) {
        const float gv = gq[k], lv = lo[k], hv = hi[k];
        lane_ok &= (lv <= __fadd_rn(gv, a.half)) & (hv >= __fsub_rn(gv, a.half));
        mx = fmaxf(mx, box_pd(lv, hv, gv));
      }
      ok = __all_sync(kFullMask, lane_ok);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
    }
    if (lane == 0) {
      a.blk[r * M + m] = ok ? b : a.nb;
      a.bhw[r * M + m] = ok ? mx : INFINITY;
    }
  });
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

Plan plan(int Q, int L, int nb, int K, int M) {
  Plan p = {};
  p.warp = K >= 32 || M > kThreadMaxM;
  p.qt = p.warp ? kSelWarps : std::min(kSelThreads, next_pow2(Q));
  p.nqt = (Q + p.qt - 1) / p.qt;
  const int64_t tiles = (int64_t)p.nqt * L;
  const int64_t want = (kChunksPerSm * (int64_t)dblsh::sm_count() + tiles - 1) / tiles;
  const int least = p.warp ? std::max(kWarpChunk, M) : kStage;
  const int64_t most = std::min<int64_t>(kMaxChunks, (nb + least - 1) / least);
  const int n = (int)std::max<int64_t>(1, std::min(want, most));
  p.chunk = (nb + n - 1) / n;
  p.nchunk = (nb + p.chunk - 1) / p.chunk;  // no empty chunk
  return p;
}

// The thread path's kernel for K < 32: block width bw = last_pow2(K), KP
// the next multiple of 4.
typedef void (*ScanKernel)(SelArgs);
ScanKernel thread_kernel(int K) {
  switch (K) {
    case 1: return select_scan_kernel<1, 4>;
    case 2:
    case 3: return select_scan_kernel<2, 4>;
    case 4: return select_scan_kernel<4, 4>;
    case 5:
    case 6:
    case 7: return select_scan_kernel<4, 8>;
    case 8: return select_scan_kernel<8, 8>;
    case 9:
    case 10:
    case 11:
    case 12: return select_scan_kernel<8, 12>;
    case 13:
    case 14:
    case 15: return select_scan_kernel<8, 16>;
    case 16: return select_scan_kernel<16, 16>;
    case 17:
    case 18:
    case 19:
    case 20: return select_scan_kernel<16, 20>;
    case 21:
    case 22:
    case 23:
    case 24: return select_scan_kernel<16, 24>;
    case 25:
    case 26:
    case 27:
    case 28: return select_scan_kernel<16, 28>;
    default: return select_scan_kernel<16, 32>;
  }
}

}  // namespace

extern "C" {

// Keys of scratch a launch for these shapes needs (int64 words).
size_t select_scratch_keys(int Q, int L, int nb, int K, int M) {
  return (size_t)L * Q * plan(Q, L, nb, K, M).nchunk * M;
}

// Returns a cudaError_t (0 = launched).  Launches both kernels on `stream`,
// no sync.  Needs 1 <= M <= nb and `part` of select_scratch_keys words;
// half is the float32 half width of the window.
int select_blocks_launch(const float* lo, const float* hi, const float* g, float half,
                         u64* part, int* blk, float* bhw, int Q, int L, int nb, int K, int M,
                         cudaStream_t stream) {
  const Plan p = plan(Q, L, nb, K, M);
  SelArgs a = {lo, hi, g, part, blk, bhw, half, Q, L, nb, K, M, p.qt, p.nchunk, p.chunk};
  const dim3 grid(p.nqt, p.nchunk, L);
  if (p.warp) {
    select_scan_warp_kernel<<<grid, kSelThreads, 0, stream>>>(a);
  } else {
    const int KP = (K + 3) & ~3;
    const size_t smem = (size_t)2 * kStage * 2 * KP * sizeof(float) +
                        (size_t)M * kSelThreads * sizeof(u64);
    const ScanKernel kernel = thread_kernel(K);
    int err = dblsh::prepare(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, kSelThreads, smem, stream>>>(a);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t rows = (int64_t)L * Q;
  select_merge_kernel<<<(unsigned)((rows + kSelWarps - 1) / kSelWarps), kSelThreads, 0,
                        stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
