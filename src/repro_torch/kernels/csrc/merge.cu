// The merge schedule for Hopper (sm_90a): kernel M1, the merge stage of the
// port's one-pass search on its fused engines
// (repro_torch.core.serve_search.search_batch_fixed, wrapper
// repro_torch/kernels/ops.py merge_schedule).
//
// Replaces no Pallas kernel: the JAX package merges in jnp, one
// merge_dedup_topk a step (repro/core/serve_search.py:680 over :411 and
// repro/core/query.py:36).  The same loop in eager PyTorch issued ~184
// launches a step (k rounds of amin / where / amin / index-put, the frozen
// wheres, the C2 and C1 marks): 1,472 a call at 8 steps and k = 10, each a
// few microseconds of device work behind ~16 microseconds of host time.
//
// What it computes (twin: repro_torch/kernels/ref.py merge_schedule_ref, the
// eager loop it replaced), per query, for j = 0 .. S-1, until the query is
// done:
//   * stats: radius_steps += 1, and B x the selected blocks with
//     prev_half < bhw <= half_j (prev_half of step 0: -inf) are added to
//     candidates and written to step_slots[j];
//   * the running top-k becomes the k lexicographically smallest DISTINCT
//     (d2, id) pairs of itself and bin j's entries of finite d2, ascending,
//     (+inf, n) past the last: pairs compare as IEEE floats, then ids, so
//     -0 and +0 are one distance and no raw float bits are ordered; a bin
//     need not be sorted or free of duplicates;
//   * C2 (use_c2): done once best_d[k-1] <= c2_j; then C1 (cum given): done
//     once cum[j] >= c1_thr; the first rule to fire names term_cause and
//     final_radius (radius_j), and a done query is frozen: its warp
//     stops.  A query never done keeps TERM_EXHAUSTED and the last
//     radius.
// The outputs are the twin's, bit for bit: every distance written is one
// of the inputs, copied.
//
// Bound on this card: bytes.  The bins (Q S kb (4 + 4) bytes: 164 KB at
// Q = 256, S = 8, kb = 10; 655 KB at Q = 1,024), the halfwidths and counts
// are read once and the outputs written once: under 0.3 us at 3.35 TB/s.
// The work, S kb insertions into a list of k a query, is ~1e6 compares at
// the cells' shapes.  What the kernel really costs is one launch in place
// of 1,472, and the latency of each query's chain of steps.
//
// Design: a warp takes one query (blocks of up to four).  Its list (k) and
// the step's bin (kb) lie in shared memory.  A step whose bin holds no
// finite pair below the list's last slot leaves the list as it is;
// otherwise the slots below the bin's least
// pair keep their places, and the rest is filled by rounds of a warp-wide
// lexicographic min select, each removing every entry equal to the pair it
// took, as the twin's topk_rounds does, until the list is full or the
// smallest left is +inf.  The lanes count a step's newly overlapped blocks
// together.  One launch a search, no scratch, no atomics: outputs are
// deterministic.  The path is the same for every k and kb; only the
// shared memory (2k + kb pairs a warp) grows with them.

#include <algorithm>

#include "search_common.cuh"

namespace {

using dblsh::kFullMask;

constexpr int kTermExhausted = 0, kTermC1 = 1, kTermC2 = 2;  // serve_search.TERM_*
constexpr int kWarpBlockMax = 4;  // warps (queries) a block

struct MergeArgs {
  const float* bins_d;      // (Q, S, kb)
  const int* bins_i;        // (Q, S, kb)
  const float* bhw;         // (Q, T) selected blocks' halfwidths, or null (no stats)
  const long long* cum;     // (Q, S) admitted slots of bins 0..j, or null (no C1)
  const float* sched;       // (3, S): half widths, C2 bounds, radii
  float* best_d;            // (Q, k)
  int* best_i;              // (Q, k)
  int* radius_steps;        // (Q,) or null
  int* candidates;          // (Q,) or null
  int* step_slots;          // (Q, S) or null (no explain)
  int* term_cause;          // (Q,) or null
  float* final_radius;      // (Q,) or null
  long long c1_thr;
  int use_c2;
  int Q, S, kb, k, T, B, n;
};

// Neither NaN nor infinite.
__device__ inline bool is_finite(float x) { return fabsf(x) < INFINITY; }

// (ad, ai) before (bd, bi): by distance as IEEE floats, then by id.
__device__ inline bool pair_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// The C2 then C1 marks of step j; true when the query is done.  Only the
// lead lane of the query writes the explain record.
__device__ inline bool mark(const MergeArgs& a, int64_t q, int j, float kth, float radius,
                            bool lead) {
  int cause = kTermExhausted;
  if (a.use_c2 && kth <= a.sched[a.S + j]) {
    cause = kTermC2;
  } else if (a.cum != nullptr && a.cum[q * a.S + j] >= a.c1_thr) {
    cause = kTermC1;
  }
  if (cause == kTermExhausted) return false;
  if (lead && a.term_cause != nullptr) {
    a.term_cause[q] = cause;
    a.final_radius[q] = radius;
  }
  return true;
}

// Blocks of the query's selection first overlapped at step j, counted over
// lanes lane, lane + stride, ... of its T halfwidths.
__device__ inline int newly_overlapped(const float* bhw, int T, float prev, float half,
                                       int lane, int stride) {
  int c = 0;
  for (int t = lane; t < T; t += stride) {
    const float b = bhw[t];
    c += (b <= half) & (b > prev);
  }
  return c;
}

// The stats of step j for an active query (lane 0 writes them).
__device__ inline void step_stats(const MergeArgs& a, int64_t q, int j, int slots,
                                  int& steps_run, int& cands) {
  steps_run += 1;
  cands += slots;
  if (a.step_slots != nullptr) a.step_slots[q * a.S + j] = slots;
}

// Outputs of a query whose schedule stopped at step `stop` (S if it ran out).
__device__ inline void finish(const MergeArgs& a, int64_t q, int stop, int steps_run,
                              int cands, bool fired) {
  if (a.radius_steps != nullptr) {
    a.radius_steps[q] = steps_run;
    a.candidates[q] = cands;
  }
  if (a.step_slots != nullptr) {
    for (int j = stop; j < a.S; ++j) a.step_slots[q * a.S + j] = 0;
    if (!fired) {
      a.term_cause[q] = kTermExhausted;
      a.final_radius[q] = a.sched[2 * a.S + a.S - 1];
    }
  }
}

// Shared memory of one warp: its list, then the bin, then the next list.
__host__ __device__ inline size_t warp_smem_bytes(int k, int kb) {
  return (size_t)(2 * k + kb) * (sizeof(float) + sizeof(int));
}

// The lexicographically least (d, i) over the warp, in every lane.
__device__ inline void warp_min(float& d, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float d2 = __shfl_xor_sync(kFullMask, d, o);
    const int i2 = __shfl_xor_sync(kFullMask, i, o);
    if (pair_less(d2, i2, d, i)) {
      d = d2;
      i = i2;
    }
  }
}

__global__ void merge_schedule_kernel(MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q = (int64_t)blockIdx.x * wpb + warp;
  if (q >= a.Q) return;  // warp-uniform
  const int k = a.k, kb = a.kb, m = k + kb;
  float* cd = reinterpret_cast<float*>(smem + warp * warp_smem_bytes(k, kb));
  int* ci = reinterpret_cast<int*>(cd + 2 * k + kb);
  float* od = cd + m;  // the next list
  int* oi = ci + m;
  for (int i = lane; i < k; i += 32) {
    cd[i] = INFINITY;
    ci[i] = a.n;
  }
  __syncwarp();
  const float* bhw = a.bhw == nullptr ? nullptr : a.bhw + q * a.T;
  int steps_run = 0, cands = 0, j = 0;
  bool fired = false;
  float prev = -INFINITY;
  for (; j < a.S && !fired; ++j) {
    const float half = a.sched[j];
    if (bhw != nullptr) {
      const int c = __reduce_add_sync(kFullMask, newly_overlapped(bhw, a.T, prev, half, lane, 32));
      if (lane == 0) step_stats(a, q, j, c * a.B, steps_run, cands);
    }
    prev = half;
    // stage the bin (non-finite distances as +inf) and find its least pair
    const float* bd = a.bins_d + (q * a.S + j) * kb;
    const int* bi = a.bins_i + (q * a.S + j) * kb;
    float md = INFINITY;
    int mi = INT_MAX;
    for (int e = lane; e < kb; e += 32) {
      const float d = is_finite(bd[e]) ? bd[e] : INFINITY;
      const int id = bi[e];
      cd[k + e] = d;
      ci[k + e] = id;
      if (pair_less(d, id, md, mi)) {
        md = d;
        mi = id;
      }
    }
    warp_min(md, mi);
    __syncwarp();
    // a pair at or above the list's last slot never enters (one equal to a
    // slot is a duplicate), so a bin with none below it leaves the list
    if (is_finite(md) && pair_less(md, mi, cd[k - 1], ci[k - 1])) {  // warp-uniform
      // the p slots below the bin's least pair are the p least pairs of
      // all: they keep their places and leave the rounds
      int p = 0;
      for (int i0 = 0; i0 < k; i0 += 32) {
        const int i = i0 + lane;
        p += __popc(__ballot_sync(kFullMask, i < k && pair_less(cd[i], ci[i], md, mi)));
      }
      __syncwarp();
      for (int i = lane; i < p; i += 32) {
        od[i] = cd[i];
        oi[i] = ci[i];
        cd[i] = INFINITY;
      }
      __syncwarp();
      int r = p;
      for (; r < k; ++r) {
        float rd = INFINITY;
        int ri = INT_MAX;
        for (int i = lane; i < m; i += 32) {
          if (pair_less(cd[i], ci[i], rd, ri)) {
            rd = cd[i];
            ri = ci[i];
          }
        }
        warp_min(rd, ri);
        if (!is_finite(rd)) break;  // warp-uniform: nothing finite is left
        if (lane == 0) {
          od[r] = rd;
          oi[r] = ri;
        }
        for (int i = lane; i < m; i += 32) {
          if (cd[i] == rd && ci[i] == ri) cd[i] = INFINITY;
        }
        __syncwarp();
      }
      for (int i = lane; i < k; i += 32) {
        cd[i] = i < r ? od[i] : INFINITY;
        ci[i] = i < r ? oi[i] : a.n;
      }
      __syncwarp();
    }
    const float kth = cd[k - 1];
    fired = mark(a, q, j, kth, a.sched[2 * a.S + j], lane == 0);  // every lane alike
    __syncwarp();
  }
  for (int i = lane; i < k; i += 32) {
    a.best_d[q * k + i] = cd[i];
    a.best_i[q * k + i] = ci[i];
  }
  if (lane == 0) finish(a, q, j, steps_run, cands, fired);
}

// Warps a block: as many as fit the shared memory, at most kWarpBlockMax.
int warps_per_block(int k, int kb) {
  const size_t per = warp_smem_bytes(k, kb);
  return (int)std::max<size_t>(1, std::min<size_t>(kWarpBlockMax, dblsh::kMaxSmem / per));
}

}  // namespace

extern "C" {

// Shared memory a block of M1 asks for at these widths; above 232,448
// bytes the launch is refused.
size_t merge_smem_bytes(int k, int kb) {
  return warp_smem_bytes(k, kb) * warps_per_block(k, kb);
}

// Returns a cudaError_t (0 = launched).  One launch on `stream`, no sync.
// Needs Q, S, k, kb >= 1.  bhw null: no stats (then radius_steps,
// candidates, step_slots, term_cause and final_radius are null too); cum
// null: no C1; step_slots null: no explain (then term_cause and
// final_radius are null).
int merge_schedule_launch(const float* bins_d, const int* bins_i, const float* bhw,
                          const long long* cum, const float* sched, float* best_d,
                          int* best_i, int* radius_steps, int* candidates, int* step_slots,
                          int* term_cause, float* final_radius, long long c1_thr,
                          int use_c2, int Q, int S, int kb, int k, int T, int B, int n,
                          cudaStream_t stream) {
  MergeArgs a = {bins_d, bins_i, bhw, cum, sched, best_d, best_i, radius_steps, candidates,
                 step_slots, term_cause, final_radius, c1_thr, use_c2, Q, S, kb, k, T, B, n};
  const int wpb = warps_per_block(k, kb);
  const size_t smem = warp_smem_bytes(k, kb) * wpb;
  if (smem > dblsh::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int err = dblsh::prepare(merge_schedule_kernel, smem);
  if (err != 0) return err;
  const unsigned grid = (unsigned)((Q + wpb - 1) / wpb);
  merge_schedule_kernel<<<grid, 32 * wpb, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
