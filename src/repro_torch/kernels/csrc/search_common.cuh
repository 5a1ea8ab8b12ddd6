// Device helpers shared by the search kernels: the fused one-pass kernels
// (fused_search.cu, B1/B2 and their quantized modes B3), the per-radius
// verify kernels (window_verify.cu, B6/B7) and the pool kernels (dist.cu,
// B4/B5).
//
// One copy of each helper is what makes the one-pass search with
// exact=True bit-equal to the multi-pass oracle inside the port: every
// kernel computes a slot's hw as the same fmaxf(fabsf(p - g)) sequence
// over k and its d2 as the same fmaf chain over i = 0..d-1, from rows
// staged in shared memory by cp.async (staged_hw, staged_d2) — and the
// kernels that select (B1/B2/B3, B6/B7) keep the k lexicographically
// smallest DISTINCT (d2, id) pairs by one rule, on 64-bit keys
// (warp_topk), so one point yields the same (d2, id) pair everywhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <mutex>

namespace dblsh {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;           // a block's shared memory on Hopper
constexpr int kMaxSplit = 4;                   // blocks in a query's cluster
constexpr int kSortLane = 16;                  // buffered keys a lane holds at most
constexpr int kSortCap = 32 * kSortLane;       // keys one warp buffers
constexpr unsigned long long kNoKey = ~0ull;   // above every (d2, id) key

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// Bytes per staged row of `rowbytes` bytes: rows that are whole 16-byte
// chunks get a stride of 16 * (odd) bytes, so the 16-byte reads of 8
// threads of a quarter warp, each in its own row, fall on distinct banks;
// other rows an odd number of 4-byte words.
__host__ __device__ inline int padded_stride(int rowbytes) {
  if (rowbytes % 16 == 0) return rowbytes + ((rowbytes / 16) % 2 == 0 ? 16 : 32);
  const int s = (rowbytes + 3) & ~3;
  return (s / 4) % 2 == 0 ? s + 4 : s;
}

// Block-wide copy of `count` floats to shared memory (strided by thread).
__device__ inline void stage(float* dst, const float* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// The distance modes of the fused kernels, numbered as the wrappers'
// `_MODES`: the float32 norm and diff forms, and kernel B3's quantized dots.
enum Mode : int { kNorm = 0, kExact = 1, kBf16 = 2, kInt8 = 3 };

// Dequantize a quantized dot and finish the norm form, in the reference's
// order: t = (xs * qs) * dot, then max(nrm - 2 t + q2, 0).  Every step is
// an explicitly rounded intrinsic, so nothing is contracted into an fma
// and the result is bit-equal to the plain PyTorch twin for the same dot.
__device__ inline float dequant_d2(float dot, float nrm, float q2, float xs, float qs) {
  const float t = __fmul_rn(__fmul_rn(xs, qs), dot);
  return fmaxf(__fadd_rn(__fsub_rn(nrm, __fmul_rn(2.0f, t)), q2), 0.0f);
}

// ------------------------------------------------------------- cp.async

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of copying an (nr x w) grid of units, row-major:
// f(row, i, u) for unit u of staged row i, whose device row rt[i] is
// valid (>= 0).  Neighbouring threads take neighbouring units, so a warp
// reads neighbouring addresses of consecutive device rows; the walk does
// no division per unit.
template <typename F>
__device__ inline void copy_grid(const int64_t* rt, int nr, int w, F f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int i = tid / w, u = tid - i * w;
  const int di = nt / w, du = nt - di * w;
  for (;;) {
    if (u >= w) {
      u -= w;
      ++i;
    }
    if (i >= nr) break;
    const int64_t row = rt[i];
    if (row >= 0) f(row, i, u);
    i += di;
    u += du;
  }
}

// ------------------------------------------------------ the slot's d2

// d2 of one staged x row: one sequential chain over i = 0..d-1 that
// depends only on (x, q), never on the slot's position, so every copy of a
// point gives a bit-identical d2.  kExact: diff form sum((x - q)^2), fmaf
// on (x - q); kNorm: the fmaf dot, then max(nrm - 2<q,x> + q2, 0); the
// quantized modes: the dot, then dequant_d2.  vec: the row is whole
// 16-byte chunks, read 16 bytes at a time, and so is the staged query;
// else element by element (the same chain).  qp: the int8 query packed
// (int8 mode).
template <int kMode>
__device__ inline float staged_d2(const char* xr, bool vec, const float* q, const int* qp,
                                  int d, float nrm, float q2, float xs, float qs) {
  if constexpr (kMode == kNorm || kMode == kExact) {
    float acc = 0.0f;
    const float* xf = reinterpret_cast<const float*>(xr);
    if (vec) {
      for (int i = 0; i < d; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xf + i);
        const float4 w = *reinterpret_cast<const float4*>(q + i);
        const float e[4] = {v.x, v.y, v.z, v.w};
        const float f[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if constexpr (kMode == kExact) {
            const float t = e[u] - f[u];
            acc = fmaf(t, t, acc);
          } else {
            acc = fmaf(e[u], f[u], acc);
          }
        }
      }
    } else {
      for (int i = 0; i < d; ++i) {
        if constexpr (kMode == kExact) {
          const float t = xf[i] - q[i];
          acc = fmaf(t, t, acc);
        } else {
          acc = fmaf(xf[i], q[i], acc);
        }
      }
    }
    if constexpr (kMode == kExact) return acc;
    return fmaxf(nrm - 2.0f * acc + q2, 0.0f);
  } else if constexpr (kMode == kBf16) {
    // q staged widened to float; a bf16 x bf16 product is exact in float32
    float acc = 0.0f;
    const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(xr);
    if (vec) {
      for (int i = 0; i < d; i += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xh + i);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const float4 w0 = *reinterpret_cast<const float4*>(q + i);
        const float4 w1 = *reinterpret_cast<const float4*>(q + i + 4);
        const float f[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = fmaf(__bfloat162float(e[u]), f[u], acc);
      }
    } else {
      for (int i = 0; i < d; ++i) acc = fmaf(__bfloat162float(xh[i]), q[i], acc);
    }
    return dequant_d2(acc, nrm, q2, xs, qs);
  } else {
    // q staged widened to int, and packed; the int32 sum is exact in any
    // order, so four-way dot products (dp4a) give the same value
    const int* qi = reinterpret_cast<const int*>(q);
    const int8_t* xb = reinterpret_cast<const int8_t*>(xr);
    int acc = 0;
    if (vec) {
      for (int i = 0; i < d; i += 16) {
        const int4 v = *reinterpret_cast<const int4*>(xb + i);
        const int4 w = *reinterpret_cast<const int4*>(qp + i / 4);
        acc = __dp4a(v.x, w.x, acc);
        acc = __dp4a(v.y, w.y, acc);
        acc = __dp4a(v.z, w.z, acc);
        acc = __dp4a(v.w, w.w, acc);
      }
    } else {
      for (int i = 0; i < d; ++i) acc += (int)xb[i] * qi[i];
    }
    return dequant_d2((float)acc, nrm, q2, xs, qs);
  }
}

// Window halfwidth of one staged projection row p against g: max_k
// |p_k - g_k| in order of k (a slot is inside the window of half width h
// iff hw <= h).  vec: K is even and p 8-byte aligned, read as float2 (a row stride of K
// floats with K/2 odd puts 16 threads' reads on distinct banks).
__device__ inline float staged_hw(const float* p, bool vec, const float* g, int K) {
  float hw = 0.0f;
  if (vec) {
    for (int k = 0; k < K; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + k);
      hw = fmaxf(hw, fabsf(v.x - g[k]));
      hw = fmaxf(hw, fabsf(v.y - g[k + 1]));
    }
  } else {
    for (int k = 0; k < K; ++k) hw = fmaxf(hw, fabsf(p[k] - g[k]));
  }
  return hw;
}

// --------------------------------------------------------- selection

// (d2, id) as one 64-bit key whose unsigned order is the lexicographic
// order of the pairs: the float's bits made monotonic, then the id with
// its sign bit flipped.
__device__ inline unsigned long long pair_key(float d, int id) {
  unsigned u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(id ^ INT_MIN);
}

__device__ inline float key_d2(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ inline int key_id(unsigned long long key) { return (int)(unsigned)key ^ INT_MIN; }

// The warp's smallest key: two single-instruction 32-bit reductions, on
// the d2 half, then on the id half among the lanes holding that d2.
__device__ inline unsigned long long warp_min_key(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32);
  const unsigned mh = __reduce_min_sync(kFullMask, hi);
  const unsigned ml = __reduce_min_sync(kFullMask, hi == mh ? (unsigned)key : 0xffffffffu);
  return ((unsigned long long)mh << 32) | ml;
}

// Calls f(key) on keys[0..m), 32 at a time (one a lane; lanes past the end
// pass kNoKey), the whole warp in step; four keys a lane are loaded ahead,
// so the loads' latencies (distributed shared memory for another block's
// keys) overlap.
template <typename F>
__device__ inline void for_flat_keys(const unsigned long long* keys, int m, F f) {
  constexpr int kAhead = 4;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < m; base += 32 * kAhead) {
    unsigned long long key[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int e = base + u * 32 + lane;
      key[u] = e < m ? keys[e] : kNoKey;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (base + u * 32 < m) f(key[u]);  // warp-uniform
  }
}

// Run by one warp: write the (at most ks) smallest distinct keys among
// the first nbuf <= 32*E keys of buf, ascending, to its front; returns how
// many.  Each lane sorts its E keys (buf[e*32 + lane]) in registers; each
// round then takes the warp-wide minimum of the lanes' smallest keys, and
// every lane holding that key drops it, so a key repeated anywhere is
// written once.
template <int E>
__device__ inline int take_smallest(unsigned long long* buf, int nbuf, int ks) {
  const int lane = threadIdx.x & 31;
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < nbuf ? buf[i] : kNoKey;
  }
  __syncwarp();
  constexpr int kLog = E == 2 ? 1 : E == 4 ? 2 : E == 8 ? 3 : 4;
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {  // bitonic network over the registers
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int p = e ^ (1 << lj);
        if (p > e) {
          const bool up = (e & (1 << lk)) == 0;
          const unsigned long long a = v[e], b = v[p];
          if ((a > b) == up) {
            v[e] = b;
            v[p] = a;
          }
        }
      }
    }
  }
  int r = 0;
  for (; r < ks; ++r) {
    const unsigned long long best = warp_min_key(v[0]);
    if (best == kNoKey) break;  // warp-uniform
    if (lane == 0) buf[r] = best;
    while (v[0] == best) {
#pragma unroll
      for (int e = 0; e + 1 < E; ++e) v[e] = v[e + 1];
      v[E - 1] = kNoKey;
    }
  }
  return r;
}

// The largest ks that warp_smallest takes: the buffer must hold the kept
// keys beside a warp's 32 new ones.
constexpr int kMaxBufferedKs = kSortCap - 32;

// Run by one warp, for ks <= kMaxBufferedKs: the (at most ks) smallest
// distinct keys below kNoKey of those for_keys passes (for_keys(f) calls
// f(key) warp-uniformly, as for_flat_keys), ascending, at the front of buf
// (the warp's kSortCap keys); returns how many.  A key below the current
// ks-th kept key joins the buffer; a full buffer (and the last) is cut to
// its ks smallest distinct keys, which set the new threshold.  The result
// does not depend on the order in which the keys come.
template <typename ForKeys>
__device__ int warp_smallest(ForKeys for_keys, int ks, unsigned long long* buf) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  int ntop = 0, nbuf = 0;
  unsigned long long T = kNoKey;  // the ks-th kept key once ks are kept
  auto flush = [&]() {
    __syncwarp();
    if (nbuf <= 64) {
      ntop = take_smallest<2>(buf, nbuf, ks);
    } else if (nbuf <= 128) {
      ntop = take_smallest<4>(buf, nbuf, ks);
    } else if (nbuf <= 256) {
      ntop = take_smallest<8>(buf, nbuf, ks);
    } else {
      ntop = take_smallest<kSortLane>(buf, nbuf, ks);
    }
    nbuf = ntop;
    __syncwarp();
    T = ntop == ks ? buf[ks - 1] : kNoKey;
  };
  for_keys([&](unsigned long long key) {
    bool take = key < T;
    unsigned bal = __ballot_sync(kFullMask, take);
    if (nbuf + __popc(bal) > kSortCap) {
      flush();
      take = key < T;
      bal = __ballot_sync(kFullMask, take);
    }
    if (take) buf[nbuf + __popc(bal & lt)] = key;
    nbuf += __popc(bal);
  });
  if (nbuf != ntop) flush();
  __syncwarp();
  return ntop;
}

// Run by one warp: the ks smallest distinct keys below kNoKey of those
// for_keys passes, ascending, to bd/bi as (d2, id); unfilled entries
// (+inf, fill).  buf: the warp's kSortCap keys.  A ks above
// kMaxBufferedKs takes ks argmin rounds, each over the keys strictly above
// the last pick.
template <typename ForKeys>
__device__ void warp_topk(ForKeys for_keys, int ks, int fill, unsigned long long* buf,
                          float* __restrict__ bd, int* __restrict__ bi) {
  const int lane = threadIdx.x & 31;
  int ntop = 0;
  if (ks <= kMaxBufferedKs) {
    ntop = warp_smallest(for_keys, ks, buf);
    for (int r = lane; r < ntop; r += 32) {
      bd[r] = key_d2(buf[r]);
      bi[r] = key_id(buf[r]);
    }
  } else {
    unsigned long long last = 0;
    for (; ntop < ks; ++ntop) {
      unsigned long long best = kNoKey;
      const bool any = ntop > 0;
      for_keys([&](unsigned long long key) {
        if ((!any || key > last) && key < best) best = key;
      });
      best = warp_min_key(best);
      if (best == kNoKey) break;  // warp-uniform
      if (lane == 0) {
        bd[ntop] = key_d2(best);
        bi[ntop] = key_id(best);
      }
      last = best;
    }
  }
  for (int r = ntop + lane; r < ks; r += 32) {
    bd[r] = INFINITY;
    bi[r] = fill;
  }
}

// ------------------------------------------------------------- launch

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0, c = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      c = 1;
    count = c;
  }
  return count;
}

// Blocks per query: the largest power of two up to kMaxSplit with
// Q * split within the SM count (and no more blocks than units of work).
inline int pick_split(int Q, int units) {
  int split = 1;
  while (split < kMaxSplit && 2 * split <= units && (int64_t)Q * split * 2 <= sm_count())
    split *= 2;
  return split;
}

// Raise a kernel's dynamic shared memory limit to `smem` bytes, once per
// kernel, device and size: cudaFuncSetAttribute runs only when a launch
// asks for more than the kernel was granted on the current device.  Where
// `blocks` is given, also set it to the blocks of `threads` threads (one
// block size per kernel) and `smem` bytes that fit on one SM, asked of the
// runtime only when the size differs from the kernel's last such call.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, int threads = 0, int* blocks = nullptr) {
  struct Grant {
    Kernel fn;
    int dev;
    size_t bytes;      // the limit granted
    size_t occ_bytes;  // the size `occ` was asked for
    int occ;           // blocks an SM at occ_bytes (0: not asked)
  };
  static std::mutex mu;
  static Grant grants[64];
  static int ngrants = 0;
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  std::lock_guard<std::mutex> lock(mu);
  Grant* g = nullptr;
  for (int i = 0; i < ngrants; ++i)
    if (grants[i].fn == kernel && grants[i].dev == dev) g = &grants[i];
  if (g == nullptr || smem > g->bytes) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    if (g == nullptr && ngrants < 64) {
      g = &grants[ngrants++];
      *g = {kernel, dev, 0, 0, 0};
    }
    if (g != nullptr) g->bytes = smem;
  }
  if (blocks == nullptr) return 0;
  if (g != nullptr && g->occ > 0 && g->occ_bytes == smem) {
    *blocks = g->occ;
    return 0;
  }
  const int err =
      (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  if (err != 0) return err;
  if (*blocks < 1) *blocks = 1;
  if (g != nullptr) {
    g->occ_bytes = smem;
    g->occ = *blocks;
  }
  return 0;
}

}  // namespace dblsh
