// What the evaluation's two top-k kernels share: the order key of a score, the radix select that
// keeps the k largest keys of a buffer, and the bitonic sort of the survivors. Included by
// csrc/topk_select.cu (a select over a score matrix, a CTA a row) and csrc/score_topk.cu (the
// scoring product and the select in one kernel, a warp per user).
//
// A key is 64 bits: the score's bits mapped to an unsigned integer in the order of the floats
// (sign flipped for a positive value, all bits flipped for a negative one; -0.0 first made +0.0,
// since the stable sort ties them), high 32 bits, then the bitwise complement of the item index,
// low 32 bits. Keys of one row are distinct, and their descending order is the card's stable
// sort order: score descending, ties to the lower index, and a NaN by its bits, as cub's radix
// sort places it (above +inf without the sign bit, below -inf with it). A real key is never 0
// (the complemented index of an item below 2^31 has its top bit set), so 0 marks an empty slot.
//
// The radix select and the sort are written once for a group of threads that share the buffer:
// the whole CTA (topk_select, 256 threads, __syncthreads) or one warp (__syncwarp).
// warp_keep_top_k is the same select for one warp with its keys in registers, one bit a pass,
// counts by ballot: score_topk cuts a user's buffer back several times in a row, and there the
// shared histogram's atomics and barriers cost several times as much.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hd_topk {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 256;                    // KMAX: the most keys one select keeps
constexpr float kNegInf = -1e9f;              // ops/topk.py NEG_INF
constexpr uint32_t kKeyNegInf = 0x319194d7u;  // order_key(-1e9f): ~0xce6e6b28

// The score's bits as an unsigned integer in the order of the floats, -0.0 as +0.0; a NaN by its
// bits, as the card's radix sort orders it.
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The least float whose key is at least `key` (-inf at or below the key of -inf; a NaN, which
// no float reaches, in the NaN keys above +inf).
__device__ __forceinline__ float key_floor(uint32_t key) {
  if (key <= 0x007fffffu) return __uint_as_float(0xff800000u);
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

__device__ __forceinline__ u64 full_key(uint32_t key, int j) {
  return (static_cast<u64>(key) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(j));
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

template <int kGroup>
__device__ __forceinline__ void group_sync() {
  if (kGroup == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// What a select leaves for the group: the bin of the k-th key, the keys above it and in it, the
// survivors gathered so far and the least of them (the new threshold).
struct SelectState {
  u64 min_kept;
  int digit;
  int above;
  int in_bin;
  int cnt_kept;
};

// Keep the k largest of the n > k distinct keys in buf[0, n) in buf[0, k) (in no order), and
// leave the k-th largest in st.min_kept. A radix select with 8-bit digits from the top: a
// warp-aggregated histogram (256 bins in `hist`) a pass, the bin of the k-th key found by one
// warp's scan, until the bin holds just the keys still needed (usually 3-4 passes); then the
// survivors are gathered into `kept` (k slots) and copied back. Called by every thread of the
// group (`rank` its index, kGroup its size: a multiple of 32, at most 256); ends synchronised.
template <int kGroup>
__device__ void radix_keep_top_k(u64* buf, int n, int k, u64* kept, unsigned* hist,
                                 SelectState& st, int rank) {
  const int lane = rank & 31;
  int need = k;
  u64 prefix = 0;
  int shift = 64;
  while (true) {
    shift -= 8;
    for (int b = rank; b < 256; b += kGroup) hist[b] = 0;
    group_sync<kGroup>();
    for (int i0 = 0; i0 < n; i0 += kGroup) {
      const int i = i0 + rank;
      const u64 v = i < n ? buf[i] : 0;
      const bool valid = i < n && (shift == 56 || (v >> (shift + 8)) == prefix);
      const unsigned d = static_cast<unsigned>(v >> shift) & 255u;
      const unsigned vm = __ballot_sync(kFull, valid);
      if (valid) {
        const unsigned peers = __match_any_sync(vm, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
      }
    }
    group_sync<kGroup>();
    if (rank < 32) {
      // lane l holds the bins 255 - 8 l down to 248 - 8 l
      unsigned c[8];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(kFull, incl >= static_cast<unsigned>(need));
      if (lane == __ffs(hit) - 1) {
        unsigned above = incl - sum;
        int j = 0;
        for (; j < 7; ++j) {
          if (above + c[j] >= static_cast<unsigned>(need)) break;
          above += c[j];
        }
        st.digit = 255 - 8 * lane - j;
        st.above = static_cast<int>(above);
        st.in_bin = static_cast<int>(c[j]);
      }
    }
    if (rank == 0) {
      st.cnt_kept = 0;
      st.min_kept = ~0ull;
    }
    group_sync<kGroup>();
    need -= st.above;
    prefix = (prefix << 8) | static_cast<u64>(st.digit);
    if (st.in_bin == need) break;  // every key of the bin is kept: keys >= prefix << shift
  }
  const u64 lo = prefix << shift;
  u64 least = ~0ull;
  for (int i0 = 0; i0 < n; i0 += kGroup) {
    const int i = i0 + rank;
    const u64 v = i < n ? buf[i] : 0;
    const bool keep = i < n && v >= lo;
    const unsigned m = __ballot_sync(kFull, keep);
    if (m) {
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&st.cnt_kept, __popc(m));
      base = __shfl_sync(kFull, base, leader);
      if (keep) kept[base + __popc(m & lanes_below(lane))] = v;
    }
    if (keep && v < least) least = v;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const u64 t = __shfl_xor_sync(kFull, least, o);
    if (t < least) least = t;
  }
  if (lane == 0) atomicMin(&st.min_kept, least);
  group_sync<kGroup>();
  for (int i = rank; i < k; i += kGroup) buf[i] = kept[i];
  group_sync<kGroup>();
}

// The same select for one warp, with the keys in registers (at most 32 kPer of them): the
// threshold T is built one bit at a time from the keys' first differing bit, each bit's count of
// keys >= T read by ballots, no shared memory and no barrier besides the warp's. It keeps the keys
// >= T in buf[0, count) and returns the count: exactly the k largest, or with `slack` > 0 it stops
// at the first T that at most k + slack keys reach. `*thresh` is T - 1: a key above it may enter.
template <int kPer>
__device__ int warp_keep_top_k(u64* buf, int n, int k, int slack, u64* thresh, int lane) {
  u64 v[kPer];
  u64 hi = 0, lo = ~0ull;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    v[m] = m * 32 + lane < n ? buf[m * 32 + lane] : 0ull;  // 0: below every key
    if (m * 32 + lane < n) {
      hi = v[m] > hi ? v[m] : hi;
      lo = v[m] < lo ? v[m] : lo;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const u64 h = __shfl_xor_sync(kFull, hi, o);
    const u64 l = __shfl_xor_sync(kFull, lo, o);
    hi = h > hi ? h : hi;
    lo = l < lo ? l : lo;
  }
  // every key shares the bits above the first where the largest and the least differ
  const int top = 63 - __clzll(static_cast<long long>(hi ^ lo));
  u64 t = hi & ~((2ull << top) - 1ull);  // at most every key: count n
  int count = n;
  for (int bit = top; bit >= 0 && count > k + slack; --bit) {
    const u64 cand = t | (1ull << bit);
    int c = 0;
#pragma unroll
    for (int m = 0; m < kPer; ++m)
      if (m * 32 < n) c += __popc(__ballot_sync(kFull, v[m] >= cand));
    if (c >= k) {
      t = cand;
      count = c;
    }
  }
  __syncwarp();  // every lane holds its keys before the survivors are written back
  int base = 0;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (m * 32 < n) {
      const bool keep = v[m] >= t && m * 32 + lane < n;
      const unsigned b = __ballot_sync(kFull, keep);
      if (keep) buf[base + __popc(b & lanes_below(lane))] = v[m];
      base += __popc(b);
    }
  }
  __syncwarp();
  *thresh = t - 1;
  return count;
}

// Sort buf[0, n) descending by a bitonic network over the power of two p >= n, the slots [n, p)
// first set to 0 (buf holds at least p slots). Called by every thread of the group; ends
// synchronised.
template <int kGroup>
__device__ void bitonic_sort_desc(u64* buf, int n, int rank) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + rank; i < p; i += kGroup) buf[i] = 0;
  group_sync<kGroup>();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = rank; t < p / 2; t += kGroup) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const u64 a = buf[lo];
        const u64 b = buf[hi];
        if ((a < b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      group_sync<kGroup>();
    }
  }
}

}  // namespace hd_topk
