// The masked top-k select of the evaluation's ranking, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package ranks with lax.top_k, an XLA op. The port took the top k
// of each [B, I] score row by masking the row's rated items (ops/topk.py mask_rated, a
// [B, I + 1] copy) and sorting the whole row stably (cub's segmented radix sort),
// which read and wrote every score several times to keep 40 of 91,599. This kernel returns the
// same values and ids, bit for bit: the k largest masked scores of each row in descending order,
// ties to the lower item index. Python binding, checks and the plain version:
// ops/kernels/topk_select.py.
//
// What bounds it on the H100: bytes. A block of the evaluation (512 users x 91,599 items, f32)
// reads 187.6 MB of scores once: 56 us at 3.35 TB/s. The rated lists (512 x 496 int32) and the
// [B, k] output are under 1% of that; the selection itself is a few integer operations a score.
//
// Design, against that bound:
//  * A CTA per row; 512 rows are one wave at 4 CTAs an SM (48 KB of shared memory each at the
//    evaluation's width), 1,024 threads an SM keeping 16 B loads in flight. Each thread streams
//    its share of the row with 128-bit loads that bypass L1 (__ldcs); a row starts only 4-byte
//    aligned (91,599 floats), so warp 0 reads the up to 3 scores before the first 16-byte
//    boundary and the up to 3 after the last one, and the body is float4s.
//  * Order as a 64-bit key: the score's bits mapped to an unsigned integer in the order of the
//    floats (sign flipped for a positive value, all bits flipped for a negative one; -0.0 first
//    made +0.0, since the stable sort ties them), high 32 bits, then the bitwise complement of
//    the item index, low 32 bits. Keys are distinct, and the descending order of keys is the
//    card's sort order: score descending, ties to the lower index, and a NaN by its bits, as
//    cub's radix sort places it (above +inf without the sign bit, below -inf with it; the CPU's
//    sort puts every NaN first). The output value is read back from the row by id (so a -0.0 or
//    a NaN keeps its bits), or is -1e9 where the key is that of -1e9. The key, the radix select
//    and the bitonic sort are topk_common.cuh's, which csrc/score_topk.cu shares.
//  * The mask: the row's rated ids (pad -1; an id outside [0, I) is ignored, a repeat is harmless)
//    become a bitmap in shared memory over a window of up to 131,072 items (16 KB; the evaluation's
//    91,599 items are one window, 11.2 KB). A masked item keeps the value -1e9 and stays a
//    candidate, as in the sort. The bitmap is read only for a score that could enter: one that
//    passes the threshold, or one at or below -1e9, which the mask could raise.
//  * Selection: a running threshold T, the k-th largest key kept so far (0 before there are k).
//    A score whose key exceeds T is appended to a candidate buffer in shared memory (one atomic a
//    warp, by ballot). Most scores cannot enter: a float4 is first held against the least float
//    that can (two float compares a score), and a warp whose 32 float4s hold no candidate skips
//    them. After each chunk of 4,096 scores the CTA syncs; when the buffer holds more
//    than KMAX keys, a radix select (8-bit digits from the top, a warp-aggregated shared
//    histogram, usually 3-4 passes) finds the k-th largest key exactly, keeps the k largest and
//    makes the k-th the new T. The first chunk fills the buffer; in a row of scores in no
//    particular order some k ln(I / 4096) more keys pass afterwards, so a row of the evaluation
//    takes one or two selects. At the end the k survivors are sorted by a bitonic network in
//    shared memory and written: values f32, ids int64, as the sort returns them.
//  * Any k: the select keeps at most KMAX (256) keys, so a larger k is served in rounds of KMAX
//    columns, each reading the row again and taking only keys below the last key of the round
//    before (keys are distinct, so the rounds join without a gap or a repeat). k <= KMAX is one
//    round, as the evaluation's k 40 is.
//  * Nothing of size [B, I] is written, and no device memory besides the output is used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using namespace hd_topk;

constexpr int kThreads = 256;
constexpr int kVec = 4;                          // float4 loads a thread has in flight a chunk
constexpr int kChunk4 = kThreads * kVec;         // float4s a chunk
constexpr int kCap = kMaxK + 4 * kChunk4;        // candidate slots: KMAX kept and a chunk
constexpr int kWindowWords = 4096;               // bitmap words: a window of 131,072 items
constexpr int kWindow = kWindowWords * 32;

struct Shared {
  u64 buf[kCap];     // candidate keys [0, cnt)
  u64 kept[kMaxK];   // the k largest, gathered by keep_top_k()
  unsigned hist[256];
  SelectState sel;
  u64 thresh;        // T
  int cnt;
};

// Whether score `x` may enter against `bar` (key_floor of the threshold's high half): at or
// above it, or at or below -1e9, which the mask may raise, or a NaN.
__device__ __forceinline__ bool may_enter(float x, float bar) {
  return (x >= bar) | !(x > kNegInf);
}

// Append `key` where `pass` holds, one atomic a warp; every lane of the warp calls it.
__device__ __forceinline__ void append(Shared& s, bool pass, u64 key, int lane) {
  const unsigned m = __ballot_sync(kFull, pass);
  if (m == 0) return;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&s.cnt, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (pass) s.buf[base + __popc(m & lanes_below(lane))] = key;
}

// Score `x` of item `j` (`ok`: a real score): append its key if it beats the threshold and is
// at most `lim`, the round's largest key.
__device__ __forceinline__ void consider(Shared& s, const uint32_t* bitmap, bool masked, bool ok,
                                         float x, int j, int w0, u64 thresh, u64 lim, int lane) {
  uint32_t key = order_key(x);
  const bool cand = ok && (key >= static_cast<uint32_t>(thresh >> 32) || key <= kKeyNegInf);
  if (cand && masked) {
    const int o = j - w0;
    if ((bitmap[o >> 5] >> (o & 31)) & 1u) key = kKeyNegInf;
  }
  const u64 full = full_key(key, j);
  append(s, cand && full > thresh && full <= lim, full, lane);
}

// Keep the k largest of the n > k keys in s.buf (exactly k: keys are distinct) in s.buf[0, k),
// s.cnt = k, and make the k-th largest the threshold. Called by every thread.
__device__ void keep_top_k(Shared& s, int n, int k, int tid) {
  radix_keep_top_k<kThreads>(s.buf, n, k, s.kept, s.hist, s.sel, tid);
  if (tid == 0) {
    s.cnt = k;
    s.thresh = s.sel.min_kept;
  }
  __syncthreads();
}

// After a chunk: select when the buffer could not take another chunk.
__device__ __forceinline__ void after_chunk(Shared& s, u64& thresh, int k, int tid) {
  __syncthreads();
  const int n = s.cnt;
  __syncthreads();  // every thread has read n before the next chunk appends
  if (n > kMaxK) {
    keep_top_k(s, n, k, tid);
    thresh = s.thresh;
  }
}

__global__ void __launch_bounds__(kThreads, 4) topk_select_kernel(
    const float* __restrict__ scores, int64_t ld, int n_items, const int* __restrict__ rated,
    int n_rated, int k, float* __restrict__ out_vals, int64_t* __restrict__ out_ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(smem + sizeof(Shared));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t r = blockIdx.x;
  const float* row = scores + r * ld;
  const int* rrow = rated != nullptr ? rated + r * n_rated : nullptr;
  const bool masked = rrow != nullptr;
  const bool one_window = n_items <= kWindow;
  u64 lim = ~0ull;  // the round's largest key: below the last key of the round before
  for (int done = 0; done < k; done += kMaxK) {
    const int kr = min(kMaxK, k - done);
    if (tid == 0) s.cnt = 0;
    u64 thresh = 0;
    for (int w0 = 0; w0 < n_items; w0 += kWindow) {
      const int len = n_items - w0 > kWindow ? kWindow : n_items - w0;
      if (masked && (done == 0 || !one_window)) {
        const int words = (len + 31) >> 5;
        for (int i = tid; i < words; i += kThreads) bitmap[i] = 0;
        __syncthreads();
        for (int i = tid; i < n_rated; i += kThreads) {
          const int o = rrow[i] - w0;
          if (o >= 0 && o < len) atomicOr(&bitmap[o >> 5], 1u << (o & 31));
        }
      }
      __syncthreads();
      const float* base = row + w0;
      const int head =
          min(len, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(base) >> 2) & 3)) & 3));
      const int n4 = (len - head) >> 2;
      const int tail = len - head - 4 * n4;
      if (tid < 32) {
        const bool ok = lane < head + tail;
        const int o = lane < head ? lane : 4 * n4 + lane;  // lane - head past the body's end
        const float x = ok ? base[o] : 0.f;
        consider(s, bitmap, masked, ok, x, w0 + o, w0, thresh, lim, lane);
      }
      after_chunk(s, thresh, kr, tid);
      const float4* body = reinterpret_cast<const float4*>(base + head);
      for (int c = 0; c < n4; c += kChunk4) {
        const float bar = key_floor(static_cast<uint32_t>(thresh >> 32));
        float4 v[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int q = c + u * kThreads + tid;
          v[u] = q < n4 ? __ldcs(body + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int q = c + u * kThreads + tid;
          const bool ok = q < n4;
          const bool any = ok && (may_enter(v[u].x, bar) | may_enter(v[u].y, bar) |
                                  may_enter(v[u].z, bar) | may_enter(v[u].w, bar));
          if (!__any_sync(kFull, any)) continue;
          const int j = w0 + head + 4 * q;
          consider(s, bitmap, masked, ok, v[u].x, j, w0, thresh, lim, lane);
          consider(s, bitmap, masked, ok, v[u].y, j + 1, w0, thresh, lim, lane);
          consider(s, bitmap, masked, ok, v[u].z, j + 2, w0, thresh, lim, lane);
          consider(s, bitmap, masked, ok, v[u].w, j + 3, w0, thresh, lim, lane);
        }
        after_chunk(s, thresh, kr, tid);
      }
    }
    // the round's kr largest, sorted descending by a bitonic network over a power of two >= kr
    int n = s.cnt;
    if (n > kr) {
      keep_top_k(s, n, kr, tid);
      n = kr;
    }
    bitonic_sort_desc<kThreads>(s.buf, n, tid);
    for (int i = tid; i < kr; i += kThreads) {
      const u64 v = s.buf[i];
      const uint32_t id = ~static_cast<uint32_t>(v);
      const int64_t o = r * k + done + i;
      out_vals[o] = static_cast<uint32_t>(v >> 32) == kKeyNegInf ? kNegInf : row[id];
      out_ids[o] = static_cast<int64_t>(id);
    }
    lim = s.buf[kr - 1] - 1;  // keys are at least 1: the complemented index is never 0
    __syncthreads();           // every thread has read the round's keys before the next appends
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing, and returns the cudaError_t of
// the launch (0 on success). `scores` [n_rows, n_items] f32 with row stride `ld` (elements, >=
// n_items) and unit column stride; `rated` [n_rows, n_rated] int32, or null for no mask;
// 1 <= k <= n_items; `vals` [n_rows, k] f32 and `ids` [n_rows, k] int64, contiguous.
extern "C" int hd_topk_select(const float* scores, int64_t ld, int n_rows, int n_items,
                              const int* rated, int n_rated, int k, float* vals, int64_t* ids,
                              void* stream) {
  if (n_rows <= 0) return 0;
  if (k < 1 || k > n_items) return static_cast<int>(cudaErrorInvalidValue);
  // the attributes once a device, at the most shared memory a launch asks for
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    const int most = static_cast<int>(sizeof(Shared)) + 4 * kWindowWords;
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(topk_select_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(topk_select_kernel),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) configured |= 1ull << dev;
  }
  const int words = n_items > kWindow ? kWindowWords : (n_items + 31) / 32;
  const int smem = static_cast<int>(sizeof(Shared)) + 4 * words;
  topk_select_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, ld, n_items, n_rated > 0 ? rated : nullptr, n_rated, k, vals, ids);
  return static_cast<int>(cudaGetLastError());
}
