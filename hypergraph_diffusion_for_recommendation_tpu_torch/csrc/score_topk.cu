// The evaluation's ranking in one kernel for Hopper (sm_90a): the scoring product of each user
// against the whole catalog and the masked top-k select, without the [B, I] score matrix.
//
// Replaces no TPU kernel: the JAX package scores with an XLA matmul (precision "highest") and
// ranks with lax.top_k. The port scored a block of 512 users with cuBLAS (a [512, 91,599] f32
// matrix) and read it back in csrc/topk_select.cu to keep 40 columns: at the LightGCN
// Amazon-Book cell's 52,736 padded users, 19.3 GB written and read again a pass, for work whose
// bound is arithmetic. This kernel returns what topk_select would return for the same score bits:
// the k largest masked scores of each user in descending order, ties to the lower item index, a
// masked item a candidate at -1e9, rated ids outside [0, I) ignored, -0.0 tied with +0.0, a NaN
// placed by its sign bit (the order key of topk_common.cuh). Python binding, checks and the
// plain version: ops/kernels/score_topk.py.
//
// What bounds it on the H100: f32 FMAs on the CUDA cores. The evaluation's 52,736 x 91,599
// scores at width 64 are 3.09e11 FMAs, 9.23 ms at 67 TFLOP/s; float32 throughout, TF32 off (no
// tensor-core format carries f32's 24-bit significand). Every other byte is small: the item table
// (23.4 MB) stays in the 50 MB L2 and is read from there once a user tile, the user rows once a
// segment, the rated lists only when a buffer is cut back, the [n, k] output once.
//
// Design, against that bound:
//  * A CTA of W warps owns a tile of 16 W users: their rows stay in shared memory, transposed, for
//    the whole segment. Two CTAs of 4 warps an SM where the width and k leave them room (the
//    evaluation's 64 and 40), else one of 8, then fewer warps. Item tiles of 128 rows are staged
//    in chunks of 16 of the width, double-buffered: each thread loads its next chunk's 32 bytes
//    into registers before it computes on the current one, and stores them transposed after,
//    one __syncthreads a chunk.
//  * A lane computes 8 users x 8 items in registers, a chain of FMAs over the width from 0 in a
//    fixed order (the sum order is the only difference from cuBLAS's product): per step two
//    128-bit loads of user values (a half warp reads one address) and two of item values
//    (conflict-free), 64 FMAs. A warp covers its 16 users against all 128 items of a tile.
//  * Each user belongs to one warp: its candidate buffer (`cap` 64-bit keys in shared memory),
//    its threshold T (a key must exceed it to enter, 0 before k) and its counts are the warp's
//    alone. After each tile a lane holds its 64 scores against its 8 users' least float that
//    could enter (the NaN-propagating max of a user's 8 scores, one compare); the scores that
//    pass are checked against T and appended, each lane its own with a shared-memory atomic, the
//    score read out of the accumulators by a tree of selects (an array indexed at run time would
//    go to local memory, as large a traffic as the score matrix). With T raised only when a
//    buffer is cut back, about 800 keys a user enter over the catalog, and most tiles of a warp
//    hold one: the pass's cost past the products is this epilogue and the cut-backs.
//  * Cutting back: the mask applied to the keys not yet checked, then the k largest, or at most
//    k + slack of the largest (cheaper, and T may be lower), kept by warp_keep_top_k of
//    topk_common.cuh: the threshold built bit by bit from the keys' first differing bit, counts
//    by ballot, in registers, since the shared histogram of the CTA's radix select costs a warp
//    several times as much. A buffer is cut back when an append finds it full, and every 8 tiles
//    every warp cuts back its users past a high-water mark at the same tile, so that the
//    barrier a chunk waits for the cut-backs of the CTA's warps together, not one by one.
//  * The mask: the unchecked keys go into a hash table in the warp's shared scratch, the user's
//    rated row (any order, pad -1, ids outside [0, I) ignored) is streamed once against it, and a
//    hit becomes the key of -1e9 with its index. A score at or below -1e9, which the mask could
//    raise, is a candidate while T is at or below that key.
//  * Filling the card: every SM's CTAs, the (user tile, item tile) iterations split evenly over
//    them (stream-K). A CTA's range covers whole user tiles, written out directly, and at most
//    two partial ones (its first and last), whose k best keys go to a workspace of [grid, 2,
//    users a tile, k]; a second, small launch merges the pieces of each split tile. Two launches
//    an evaluation, whatever its size; nothing of size [B, I] exists.
//  * Output: the survivors sorted by the bitonic network of topk_common.cuh; each value computed
//    again by the same FMA chain (so -0.0 and NaN keep the bits the ranking saw), or -1e9 for the
//    key of -1e9; ids int64.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): 30.4-30.7 ms at the evaluation's shape on N(0, 1)
// tables, 30% of the bound; the products alone, the epilogue skipped, 18.2 ms (51%). PERF.md
// keeps the readings and what was tried.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using namespace hd_topk;

constexpr int kBI = 128;            // items a tile
constexpr int kBK = 16;             // width of a staged chunk of the item tile
constexpr int kUsersPerWarp = 16;   // two half warps of 8 users
constexpr int kMaxD = 256;          // the widest user and item rows taken
constexpr int kMaxCap = 512;        // the most candidate slots a user
constexpr int kHash = 1024;         // u16 slots of a warp's hash of unchecked candidates
constexpr int kMergeWarps = 4;
constexpr int kCutEvery = 8;        // tiles between rounds of cut-backs
constexpr int kHighWater = 32;      // free slots below which a round cuts a buffer back

struct WarpScratch {
  unsigned short hash[kHash];  // the mask check's table of unchecked keys (slot + 1, 0 empty)
};

struct UserState {
  u64 thresh;  // T: a key above it may enter (0 before k keys)
  int cnt;     // keys in the buffer
  int chk;     // keys [0, chk) have had the mask applied
};

struct Params {
  const float* user_emb;
  const float* item_emb;
  const void* users;
  const int* rated;  // null: no mask
  float* vals;
  int64_t* ids;
  u64* partial;  // [grid, 2, users a tile, k]
  int64_t ld_u, ld_i, ld_r;
  int64_t total;  // (user tile, item tile) iterations
  int users64, n, n_items, d, n_rated, k, cap, slack, n_jt, grid, vec;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int64_t user_row(const Params& p, int r) {
  return p.users64 ? static_cast<const int64_t*>(p.users)[r] : static_cast<const int*>(p.users)[r];
}

// CTA g's iterations are [range_start(g), range_start(g + 1)).
__device__ __forceinline__ int64_t range_start(const Params& p, int g) {
  return static_cast<int64_t>(g) * p.total / p.grid;
}

__device__ int cta_of(const Params& p, int64_t x) {
  int g = static_cast<int>(x * p.grid / p.total);
  while (g + 1 < p.grid && range_start(p, g + 1) <= x) ++g;
  while (g > 0 && range_start(p, g) > x) --g;
  return g;
}

// The least float that can enter against T: -inf while T is at or below the key of -1e9 (the
// mask may raise any score to it), +inf for a padding user.
__device__ __forceinline__ float bar_of(u64 thresh, bool valid) {
  if (!valid) return __uint_as_float(0x7f800000u);
  const uint32_t hi = static_cast<uint32_t>(thresh >> 32);
  return hi <= kKeyNegInf ? __uint_as_float(0xff800000u) : key_floor(hi);
}

// The score of user row `urow` against item `id`: the main loop's FMA chain.
__device__ __forceinline__ float score(const Params& p, const float* urow, int id) {
  const float* irow = p.item_emb + static_cast<int64_t>(id) * p.ld_i;
  float acc = 0.f;
  for (int kk = 0; kk < p.d; ++kk) acc = fmaf(urow[kk], irow[kk], acc);
  return acc;
}

// Write the n sorted keys of output row r (one warp).
__device__ void write_row(const Params& p, int r, const u64* b, int n, int lane) {
  const float* urow = p.user_emb + user_row(p, r) * p.ld_u;
  for (int i = lane; i < n; i += 32) {
    const u64 v = b[i];
    const uint32_t id = ~static_cast<uint32_t>(v);
    const int64_t o = static_cast<int64_t>(r) * p.k + i;
    p.vals[o] = static_cast<uint32_t>(v >> 32) == kKeyNegInf ? kNegInf : score(p, urow, id);
    p.ids[o] = static_cast<int64_t>(id);
  }
}

// The mask on keys b[from, to) of user row r (one warp): a hit in the rated row becomes the key
// of -1e9 with its index.
__device__ void mask_check(const Params& p, u64* b, int from, int to, int r, unsigned short* hash,
                           int lane) {
  u64* h64 = reinterpret_cast<u64*>(hash);
  for (int s = lane; s < kHash / 4; s += 32) h64[s] = 0;
  __syncwarp();
  for (int q = from + lane; q < to; q += 32) {
    const uint32_t id = ~static_cast<uint32_t>(b[q]);
    uint32_t s = (id * 2654435761u) >> 22;
    while (atomicCAS(&hash[s], static_cast<unsigned short>(0),
                     static_cast<unsigned short>(q + 1)) != 0) {
      s = (s + 1) & (kHash - 1);
    }
  }
  __syncwarp();
  const int* rrow = p.rated + user_row(p, r) * p.ld_r;
  constexpr int kBatch = 16;  // rated ids a lane has in flight
  for (int q0 = 0; q0 < p.n_rated; q0 += kBatch * 32) {
    int ids[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * 32 + lane;
      ids[u] = q < p.n_rated ? __ldg(rrow + q) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int id = ids[u];
      if (id < 0 || id >= p.n_items) continue;
      uint32_t s = (static_cast<uint32_t>(id) * 2654435761u) >> 22;
      while (true) {
        const int e = hash[s];
        if (e == 0) break;
        if (~static_cast<uint32_t>(b[e - 1]) == static_cast<uint32_t>(id)) {
          b[e - 1] = full_key(kKeyNegInf, id);
          break;
        }
        s = (s + 1) & (kHash - 1);
      }
    }
  }
  __syncwarp();
}

// Cut a user's buffer back (one warp): the mask on the unchecked keys, then, past k keys, the
// largest kept and T raised to the least of them: exactly the k largest with `exact`, else at
// most k + slack of the largest (a radix select stopped early), which leaves the buffer room at
// a fraction of an exact select's passes. Either starts at the keys' first differing byte.
__device__ __noinline__ void cut_back(const Params& p, WarpScratch& ws, UserState& st, u64* b,
                                      int r, int lane, bool exact) {
  const int n = min(st.cnt, p.cap);  // appends past a full buffer claimed no slot
  if (p.rated != nullptr && st.chk < n)
    mask_check(p, b, st.chk, n, r, ws.hash, lane);
  if (n > p.k) {
    u64 thresh = 0;
    const int kept = warp_keep_top_k<kMaxCap / 32>(b, n, p.k, exact ? 0 : p.slack, &thresh, lane);
    if (lane == 0) {
      st.cnt = kept;
      st.thresh = thresh;
    }
  } else if (lane == 0) {
    st.cnt = n;
  }
  __syncwarp();
  if (lane == 0) st.chk = st.cnt;
  __syncwarp();
}

// Whether score x of item j enters user row r's buffer against T: a real item, and a key above
// T, or one at or below -1e9 that the mask could raise above T.
__device__ __forceinline__ bool enters(const Params& p, float x, int j, u64 thresh) {
  const uint32_t key = order_key(x);
  return j < p.n_items && (full_key(key, j) > thresh ||
                           (p.rated != nullptr && key <= kKeyNegInf &&
                            full_key(kKeyNegInf, j) > thresh));
}

// Score 8 i + jj of a lane's 8 x 8 accumulators, the index known only at run time, by a tree
// of selects (no local memory).
__device__ __forceinline__ float pick64(const float (&a)[8][8], int bit) {
  float row[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float s0 = (bit & 8) ? a[1][jj] : a[0][jj], s1 = (bit & 8) ? a[3][jj] : a[2][jj];
    const float s2 = (bit & 8) ? a[5][jj] : a[4][jj], s3 = (bit & 8) ? a[7][jj] : a[6][jj];
    const float t0 = (bit & 16) ? s1 : s0, t1 = (bit & 16) ? s3 : s2;
    row[jj] = (bit & 32) ? t1 : t0;
  }
  const int jj = bit & 7;
  const float a0 = (jj & 1) ? row[1] : row[0], a1 = (jj & 1) ? row[3] : row[2];
  const float a2 = (jj & 1) ? row[5] : row[4], a3 = (jj & 1) ? row[7] : row[6];
  const float b0 = (jj & 2) ? a1 : a0, b1 = (jj & 2) ? a3 : a2;
  return (jj & 4) ? b1 : b0;
}

// Append a tile's entering scores to their users' buffers (one warp; `todo` bit 8 i + jj: the
// lane's score of user ubase + i, item jj, passed the cheap test). Each lane appends its own
// with a shared-memory atomic a key; a key that finds its buffer full is kept back, the full
// buffers are cut back, and the kept keys are tried again against the raised T. Returns whether
// a T was raised.
__device__ __forceinline__ bool append_tile(const Params& p, WarpScratch& ws, UserState* us,
                                            u64* bufs, const float (&acc)[8][8], uint64_t todo,
                                            int t, int bu, int ubase, int jbase, int lane) {
  uint64_t left = todo;  // not yet placed
  bool cut = false;
  while (true) {
    for (uint64_t rest = left; rest; rest &= rest - 1) {
      const int bit = __ffsll(static_cast<long long>(rest)) - 1;
      const int i = bit >> 3, jj = bit & 7;
      UserState& st = us[ubase + i];
      const int j = jbase + (jj < 4 ? jj : 60 + jj);
      const float x = pick64(acc, bit);
      if (t * bu + ubase + i >= p.n || !enters(p, x, j, st.thresh)) {
        left &= ~(1ull << bit);  // a padding user, or below T
        continue;
      }
      const int pos = atomicAdd(&st.cnt, 1);
      if (pos < p.cap) {
        bufs[static_cast<int64_t>(ubase + i) * p.cap + pos] = full_key(order_key(x), j);
        left &= ~(1ull << bit);
      }
    }
    __syncwarp();
    if (!__any_sync(kFull, left != 0)) break;
    // the users whose buffers filled, each half warp's 8 by bit
    unsigned full = 0;
    for (int i = 0; i < 8; ++i) full |= static_cast<unsigned>(((left >> (8 * i)) & 0xffull) != 0) << i;
    const unsigned lo = __reduce_or_sync(kFull, lane < 16 ? full : 0u);
    const unsigned hi = __reduce_or_sync(kFull, lane < 16 ? 0u : full);
    const int u0 = ubase - (lane < 16 ? 0 : 8);  // the first half warp's users
    for (unsigned m = lo | (hi << 8); m; m &= m - 1) {
      const int ul = u0 + __ffs(m) - 1;
      cut_back(p, ws, us[ul], bufs + static_cast<int64_t>(ul) * p.cap, t * bu + ul, lane, false);
    }
    cut = true;
  }
  return __any_sync(kFull, cut);
}

template <int W>
__global__ void __launch_bounds__(32 * W, 1) score_topk_kernel(const Params p) {
  constexpr int kT = 32 * W;
  constexpr int kBU = kUsersPerWarp * W;
  constexpr int kUnits = (kBI * kBK / 8) / kT;  // 8-float pieces of a chunk a thread stages
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  const int nch = (d + kBK - 1) / kBK;
  const int dpad = nch * kBK;
  float* sB = reinterpret_cast<float*>(smem);  // [2][kBK][kBI]
  float* sA = sB + 2 * kBK * kBI;              // [dpad][kBU]
  WarpScratch* ws = reinterpret_cast<WarpScratch*>(sA + dpad * kBU);
  UserState* us = reinterpret_cast<UserState*>(ws + W);
  u64* bufs = reinterpret_cast<u64*>(us + kBU);  // [kBU][cap]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int half = lane >> 4;
  const int col = lane & 15;
  const int64_t s0 = range_start(p, blockIdx.x);
  const int64_t s1 = range_start(p, blockIdx.x + 1);
  const int t_first = static_cast<int>(s0 / p.n_jt);

  // stage chunk `ch` of item tile `jt` into registers, then into sB transposed
  float stage[kUnits][8];
  auto load_chunk = [&](int jt, int ch) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int q = tid + u * kT;
      const int j = jt * kBI + (q & (kBI - 1));
      const int c0 = ch * kBK + (q / kBI) * 8;
      if (j < p.n_items) {
        const float* row = p.item_emb + static_cast<int64_t>(j) * p.ld_i + c0;
        if (p.vec && c0 + 8 <= d) {
          const float4 v0 = __ldg(reinterpret_cast<const float4*>(row));
          const float4 v1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
          stage[u][0] = v0.x; stage[u][1] = v0.y; stage[u][2] = v0.z; stage[u][3] = v0.w;
          stage[u][4] = v1.x; stage[u][5] = v1.y; stage[u][6] = v1.z; stage[u][7] = v1.w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) stage[u][e] = c0 + e < d ? __ldg(row + e) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) stage[u][e] = 0.f;
      }
    }
  };
  auto store_chunk = [&](float* dst) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int q = tid + u * kT;
      const int jl = q & (kBI - 1);
      const int k0 = (q / kBI) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(k0 + e) * kBI + jl] = stage[u][e];
    }
  };

  for (int64_t x = s0; x < s1;) {
    const int t = static_cast<int>(x / p.n_jt);
    const int j0 = static_cast<int>(x - static_cast<int64_t>(t) * p.n_jt);
    const int j1 = static_cast<int>(min(static_cast<int64_t>(p.n_jt),
                                        s1 - static_cast<int64_t>(t) * p.n_jt));
    x = static_cast<int64_t>(t) * p.n_jt + j1;
    const bool whole = j0 == 0 && j1 == p.n_jt;
    const int slot = t == t_first ? 0 : 1;

    __syncthreads();  // the last segment's reads of sA and sB are done
    for (int e = tid; e < kBU * dpad; e += kT) {
      const int ul = e / dpad;
      const int kk = e - ul * dpad;
      const int r = t * kBU + ul;
      float v = 0.f;
      if (r < p.n && kk < d) v = p.user_emb[user_row(p, r) * p.ld_u + kk];
      sA[kk * kBU + ul] = v;
    }
    if (lane < kUsersPerWarp) us[warp * kUsersPerWarp + lane] = UserState{0ull, 0, 0};
    const int ubase = warp * kUsersPerWarp + 8 * half;  // this lane's users: ubase + i
    float bar[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) bar[i] = bar_of(0ull, t * kBU + ubase + i < p.n);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

    const int n_it = (j1 - j0) * nch;
    load_chunk(j0, 0);
    store_chunk(sB);
    __syncthreads();
    int jt = j0, ch = 0;
    for (int it = 0; it < n_it; ++it) {
      const float* bcur = sB + (it & 1) * kBK * kBI + 4 * col;
      const float* acur = sA + ch * kBK * kBU + ubase;
      const int nj = ch + 1 == nch ? jt + 1 : jt;
      const int nc = ch + 1 == nch ? 0 : ch + 1;
      if (it + 1 < n_it) load_chunk(nj, nc);
      const int kv = min(kBK, d - ch * kBK);
      auto step = [&](int kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(acur + kk * kBU);
        const float4 a1 = *reinterpret_cast<const float4*>(acur + kk * kBU + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(bcur + kk * kBI);
        const float4 b1 = *reinterpret_cast<const float4*>(bcur + kk * kBI + 64);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      };
      if (kv == kBK) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) step(kk);
      } else {
        for (int kk = 0; kk < kv; ++kk) step(kk);
      }

      if (ch + 1 == nch) {
        // the tile's epilogue: most tiles hold no score that could enter
        unsigned pre = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float m = acc[i][0];
#pragma unroll
          for (int jj = 1; jj < 8; ++jj) m = max_nan(m, acc[i][jj]);
          pre |= static_cast<unsigned>(!(m < bar[i])) << i;
        }
        if (__any_sync(kFull, pre)) {
          uint64_t todo = 0;  // the lane's scores that pass the cheap test
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              todo |= static_cast<uint64_t>(((pre >> i) & 1u) && !(acc[i][jj] < bar[i]))
                      << (8 * i + jj);
          if (append_tile(p, ws[warp], us, bufs, acc, todo, t, kBU, ubase, jt * kBI + 4 * col,
                          lane)) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              bar[i] = bar_of(us[ubase + i].thresh, t * kBU + ubase + i < p.n);
          }
        }
        if ((jt - j0) % kCutEvery == kCutEvery - 1) {
          // a round of cut-backs: each warp its users past the high-water mark, all warps at the
          // same tile, so that their cut-backs overlap instead of stalling the CTA one by one
          bool cut = false;
          for (int q = 0; q < kUsersPerWarp; ++q) {
            const int ul = warp * kUsersPerWarp + q;
            if (t * kBU + ul < p.n && us[ul].cnt > p.cap - kHighWater) {
              cut_back(p, ws[warp], us[ul], bufs + static_cast<int64_t>(ul) * p.cap, t * kBU + ul,
                       lane, false);
              cut = true;
            }
          }
          if (cut) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              bar[i] = bar_of(us[ubase + i].thresh, t * kBU + ubase + i < p.n);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
      }
      if (it + 1 < n_it) store_chunk(sB + ((it + 1) & 1) * kBK * kBI);
      __syncthreads();
      jt = nj;
      ch = nc;
    }

    // the segment's k best of each of the warp's users: written out, or left for the merge
    for (int q = 0; q < kUsersPerWarp; ++q) {
      const int ul = warp * kUsersPerWarp + q;
      const int r = t * kBU + ul;
      if (r >= p.n) break;
      UserState& st = us[ul];
      u64* b = bufs + static_cast<int64_t>(ul) * p.cap;
      cut_back(p, ws[warp], st, b, r, lane, true);
      const int n = st.cnt;
      if (whole) {
        bitonic_sort_desc<32>(b, n, lane);
        write_row(p, r, b, n, lane);
      } else {
        u64* dst = p.partial + ((static_cast<int64_t>(blockIdx.x) * 2 + slot) * kBU + ul) * p.k;
        for (int i = lane; i < p.k; i += 32) dst[i] = i < n ? b[i] : 0ull;
      }
      __syncwarp();
    }
  }
}

// The split user tiles: each user's pieces (k keys each, 0 for an empty slot) merged, sorted and
// written. A CTA a user tile; tiles one CTA covered return at once.
__global__ void __launch_bounds__(32 * kMergeWarps) score_topk_merge(const Params p, int bu) {
  __shared__ u64 bufs[kMergeWarps][2 * kMaxK];
  const int t = blockIdx.x;
  const int g0 = cta_of(p, static_cast<int64_t>(t) * p.n_jt);
  const int g1 = cta_of(p, static_cast<int64_t>(t + 1) * p.n_jt - 1);
  if (g0 == g1) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  u64* b = bufs[warp];
  for (int ul = warp; ul < bu; ul += kMergeWarps) {
    const int r = t * bu + ul;
    if (r >= p.n) break;
    int cnt = 0;
    for (int g = g0; g <= g1; ++g) {
      const int slot = t == static_cast<int>(range_start(p, g) / p.n_jt) ? 0 : 1;
      const u64* src = p.partial + ((static_cast<int64_t>(g) * 2 + slot) * bu + ul) * p.k;
      for (int i0 = 0; i0 < p.k; i0 += 32) {
        const u64 v = i0 + lane < p.k ? src[i0 + lane] : 0ull;
        const unsigned m = __ballot_sync(kFull, v != 0);
        if (v != 0) b[cnt + __popc(m & lanes_below(lane))] = v;
        cnt += __popc(m);
      }
      __syncwarp();
      if (cnt > p.k) {
        u64 thresh = 0;
        cnt = warp_keep_top_k<2 * kMaxK / 32>(b, cnt, p.k, 0, &thresh, lane);
      }
    }
    bitonic_sort_desc<32>(b, cnt, lane);
    write_row(p, r, b, cnt, lane);
    __syncwarp();
  }
}

struct Plan {
  int warps;
  int cap;
  int grid;
  int smem;
};

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

size_t fixed_smem(int w, int d) {
  const int dpad = (d + kBK - 1) / kBK * kBK;
  return sizeof(float) * (2 * kBK * kBI + static_cast<size_t>(dpad) * kUsersPerWarp * w) +
         w * sizeof(WarpScratch) + kUsersPerWarp * w * sizeof(UserState);
}

template <int W>
cudaError_t configure(int dev, int smem_max) {
  static unsigned long long done = 0;
  if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(score_topk_kernel<W>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(score_topk_kernel<W>),
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

template <int W>
cudaError_t occupancy(int smem, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(score_topk_kernel<W>), 32 * W, smem);
}

// The CTA's warps and the CTAs an SM, the buffers' slots, and the grid. In order of preference:
// two CTAs of 4 warps an SM (a cut-back in one stalls only its own 4 warps at their barrier), one
// of 8, then fewer warps, the first whose users' buffers hold k + 64 keys, else the first that
// holds k + 16 and a power of two >= k. The grid fills every SM; each (user tile, item tile)
// iteration once.
cudaError_t make_plan(int n, int n_items, int d, int k, Plan* pl) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0, smem_max = 0, smem_sm = 0, reserved = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int need = k + 16 > pow2_at_least(k) ? k + 16 : pow2_at_least(k);
  const int shapes[5][2] = {{4, 2}, {8, 1}, {4, 1}, {2, 1}, {1, 1}};  // (warps, CTAs an SM)
  int chosen = 0, per_sm = 1, cap = 0;
  for (int pass = 0; pass < 2 && chosen == 0; ++pass) {
    for (const auto& shape : shapes) {
      const int w = shape[0];
      const int budget = shape[1] == 1 ? smem_max : smem_sm / shape[1] - reserved;
      const size_t fx = fixed_smem(w, d);
      if (fx >= static_cast<size_t>(budget)) continue;
      const int fit = static_cast<int>((budget - fx) / (kUsersPerWarp * w * sizeof(u64)));
      if (fit >= (pass == 0 ? need + 48 : need)) {
        chosen = w;
        per_sm = shape[1];
        cap = fit < kMaxCap ? fit : kMaxCap;
        break;
      }
    }
  }
  if (chosen == 0) return cudaErrorInvalidValue;
  pl->warps = chosen;
  pl->cap = cap;
  pl->smem = static_cast<int>(fixed_smem(chosen, d) + kUsersPerWarp * chosen * cap * sizeof(u64));
  switch (chosen) {
    case 8: err = configure<8>(dev, smem_max); break;
    case 4: err = configure<4>(dev, smem_max); break;
    case 2: err = configure<2>(dev, smem_max); break;
    default: err = configure<1>(dev, smem_max); break;
  }
  if (err != cudaSuccess) return err;
  int blocks = 0;
  switch (chosen) {
    case 8: err = occupancy<8>(pl->smem, &blocks); break;
    case 4: err = occupancy<4>(pl->smem, &blocks); break;
    case 2: err = occupancy<2>(pl->smem, &blocks); break;
    default: err = occupancy<1>(pl->smem, &blocks); break;
  }
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const int bu = kUsersPerWarp * chosen;
  const int64_t total =
      static_cast<int64_t>((n + bu - 1) / bu) * ((n_items + kBI - 1) / kBI);
  const int64_t grid = static_cast<int64_t>(sms) * (blocks < per_sm ? blocks : per_sm);
  pl->grid = static_cast<int>(grid < total ? grid : total);
  return cudaSuccess;
}

bool bad_shape(int n, int n_items, int d, int k) {
  return n < 0 || n_items < 1 || n_items > (1 << 30) || d < 1 || d > kMaxD || k < 1 ||
         k > kMaxK || k > n_items;
}

}  // namespace

// The workspace `hd_score_topk` needs for these shapes, in bytes (0 on success, else the
// cudaError_t).
extern "C" int hd_score_topk_workspace(int n, int n_items, int d, int k, int64_t* bytes) {
  if (bad_shape(n, n_items, d, k)) return static_cast<int>(cudaErrorInvalidValue);
  *bytes = 0;
  if (n == 0) return 0;
  Plan pl;
  const cudaError_t err = make_plan(n, n_items, d, k, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = static_cast<int64_t>(pl.grid) * 2 * kUsersPerWarp * pl.warps * k * sizeof(u64);
  return 0;
}

// Launches on `stream` (the ranking, then the merge of split user tiles), does not synchronise,
// allocates nothing, and returns the cudaError_t of the launches (0 on success). Row r of the
// output is user users[r] (int32, or int64 with users64): user_emb [*, d] f32 with row stride
// ld_u, item_emb [n_items, d] f32 with row stride ld_i, rated [*, n_rated] int32 with row stride
// ld_r, or null for no mask; 1 <= k <= min(n_items, 256), 1 <= d <= 256; vals [n, k] f32 and ids
// [n, k] int64, contiguous; `workspace` of hd_score_topk_workspace's bytes.
extern "C" int hd_score_topk(const float* user_emb, int64_t ld_u, const void* users, int users64,
                             int n, const float* item_emb, int64_t ld_i, int n_items, int d,
                             const int* rated, int64_t ld_r, int n_rated, int k, float* vals,
                             int64_t* ids, void* workspace, int64_t workspace_bytes,
                             void* stream) {
  if (bad_shape(n, n_items, d, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Plan pl;
  cudaError_t err = make_plan(n, n_items, d, k, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bu = kUsersPerWarp * pl.warps;
  if (workspace_bytes < static_cast<int64_t>(pl.grid) * 2 * bu * k * sizeof(u64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.user_emb = user_emb;
  p.item_emb = item_emb;
  p.users = users;
  p.rated = n_rated > 0 ? rated : nullptr;
  p.vals = vals;
  p.ids = ids;
  p.partial = static_cast<u64*>(workspace);
  p.ld_u = ld_u;
  p.ld_i = ld_i;
  p.ld_r = ld_r;
  p.users64 = users64;
  p.n = n;
  p.n_items = n_items;
  p.d = d;
  p.n_rated = n_rated;
  p.k = k;
  p.cap = pl.cap;
  // an intermediate cut keeps at most k + slack keys: a quarter of the room a cut makes
  p.slack = (pl.cap - k - 16) / 4;
  p.n_jt = (n_items + kBI - 1) / kBI;
  const int n_tiles = (n + bu - 1) / bu;
  p.total = static_cast<int64_t>(n_tiles) * p.n_jt;
  p.grid = pl.grid;
  p.vec = (reinterpret_cast<uintptr_t>(item_emb) % 16 == 0) && (ld_i % 4 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.warps) {
    case 8: score_topk_kernel<8><<<pl.grid, 256, pl.smem, s>>>(p); break;
    case 4: score_topk_kernel<4><<<pl.grid, 128, pl.smem, s>>>(p); break;
    case 2: score_topk_kernel<2><<<pl.grid, 64, pl.smem, s>>>(p); break;
    default: score_topk_kernel<1><<<pl.grid, 32, pl.smem, s>>>(p); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.grid == 1) return static_cast<int>(err);
  score_topk_merge<<<n_tiles, 32 * kMergeWarps, 0, s>>>(p, bu);
  return static_cast<int>(cudaGetLastError());
}
