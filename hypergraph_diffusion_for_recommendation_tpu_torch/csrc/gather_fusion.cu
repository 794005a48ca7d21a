// The gather-fusion probe kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of scripts/bench_gather_fusion.py, a microbenchmark that asks
// whether a gather from a table kept in fast memory beats the row gather outside the kernel:
//   resident_row_gather  <- gather_kernel (:86, call :92):  out[e] = X[idx[e]]
//   fused_window_spmm    <- fused_kernel  (:125, call :162): out = A @ X over the row-window layout
//                           of pack_blocked, the gather fused into the product
// Python binding, checks and the plain versions: ops/kernels/gather_fusion.py. The probe that
// drives them: bench/gather_fusion.py.
//
// What bounds them on the H100: bytes. The gather moves X (10 MB in f32 at the probe's 19712 x 128)
// and writes nnz x d rows (134 MB at nnz = 262144, d = 128): 0.0434 ms at 3.35 TB/s. The fused
// product reads X once, 12 B per edge and writes the [N, d] output: 0.0070 ms, while its
// 2 * nnz * d f32 multiply-adds take 0.0010 ms at 67 TFLOP/s.
//
// Design, against that bound:
//  * The TPU kernels keep X "resident" in VMEM. X does not fit a Hopper CTA's 227 KB of shared
//    memory; its residence here is the 50 MB L2, which holds all of it, so neither kernel keeps a
//    software cache of X. The gather is a warp per output row: each lane copies 16 bytes (a row of
//    128 f32 is one 512 B read and one 512 B write per warp; in bf16 half the lanes copy 256 B).
//    An index outside [0, n) is clamped into it: the kernel reads nothing outside X.
//  * The fused product reads only what the TPU kernel reads: the pack_blocked arrays wmap, cols,
//    local_rows and vals, and X; none of the base SpMM kernel's port-only work lists. The TPU grid
//    walks a window's edge blocks in order and accumulates the window's [rb, d] tile across grid
//    steps; on Hopper nothing carries over between CTAs, so the work is cut by rows instead: a CTA
//    takes kRowsPerCta rows of one window (grid n_windows x rb / 32: 616 CTAs at the probe, a
//    single wave of some 37 warps an SM). It finds its window's slot range by a search on wmap and
//    its rows' slot bounds by a search on local_rows over that range (within a window local_rows
//    does not decrease: pack_blocked fills a window's slots in row order and puts its pads, = rb,
//    at the tail), both searches by the whole CTA, 256 entries a round (two rounds each at the
//    probe), then one pass over its slots marks where each row starts. Each warp then sums
//    kRowsPerCta / 8 consecutive rows one at a time in registers, as the base SpMM kernel does: a
//    lane reads 16 B of an X row (4 f32 or 8 bf16 features), so a team of G lanes covers a row;
//    the warp holds 32 slots' (col, val), one a lane, broadcasts them by shuffles, keeps kGather X
//    rows in flight a team, loads the next row's first 32 slots while this row's gathers are in
//    flight, and adds the teams' sums by a fixed shuffle tree. Every output row is written once by
//    one warp (an empty row, or a row of an empty window, as zeros): no shared tile, no atomics of
//    any kind, no zero fill, and two calls give the same bits.
//  * What limits it now: the latency of the dependent L2 reads (two searches of two rounds, the
//    slot loads, then a round of gathers per 4 edges of a row in f32, per 8 in bf16 with its two
//    teams, at the probe's 13 edges a row), not bytes: the gathers move nnz * d * 4 B = 134 MB in
//    f32 out of the L2, not the 10 MB of X once.
//  * bf16 mode follows the TPU kernel: X arrives as bf16 (the wrapper casts the table once), each
//    edge value is rounded to bf16, their product is rounded to bf16 (the Pallas kernel
//    multiplies the two bf16 operands in bf16), and the sums are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerCta = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerCta = 32;  // window rows a CTA of the fused kernel sums: 4 a warp
constexpr int kGather = 4;       // X rows a team of the fused kernel keeps in flight

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A lane's 16-byte share of an X row in the fused kernel: kN features; round() rounds an edge
// value and add() adds its products as the TPU kernel rounds them.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void add(float (&acc)[kN], float v, const uint4& r) {
    acc[0] = fmaf(v, __uint_as_float(r.x), acc[0]);
    acc[1] = fmaf(v, __uint_as_float(r.y), acc[1]);
    acc[2] = fmaf(v, __uint_as_float(r.z), acc[2]);
    acc[3] = fmaf(v, __uint_as_float(r.w), acc[3]);
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float round(float v) { return bf16_round(v); }
  static __device__ __forceinline__ void add(float (&acc)[kN], float v, const uint4& r) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      acc[2 * k] += bf16_round(v * f.x);  // bf16 x bf16 is exact in f32, then rounded to bf16
      acc[2 * k + 1] += bf16_round(v * f.y);
    }
  }
};

__device__ __forceinline__ void store(float* o, const float (&a)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store(float* o, const float (&a)[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// One warp per output row: lane i copies the 16-byte vectors i, i + 32, ... of the row.
__global__ void __launch_bounds__(kThreads) resident_row_gather_kernel(
    const int* __restrict__ idx, const uint4* __restrict__ x, uint4* __restrict__ out,
    int64_t n_out, int n_src, int vecs) {
  const int lane = threadIdx.x % kWarp;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + threadIdx.x / kWarp;
  if (r >= n_out) return;
  const int src = min(max(idx[r], 0), n_src - 1);
  const uint4* s = x + static_cast<int64_t>(src) * vecs;
  uint4* o = out + r * vecs;
  for (int v = lane; v < vecs; v += kWarp) o[v] = s[v];
}

// For two keys at once, the first index i in [lo, hi) of the non-decreasing `a` with a[i] >= key
// (hi if none), found by the whole CTA: every thread calls it and gets both answers. A round
// samples kThreads evenly spaced entries of each range; the entries below the key are a prefix,
// counted by a barrier, and the range shrinks to the stretch after the last of them.
__device__ int2 cta_first_at_least(const int* __restrict__ a, int lo, int hi, int key0,
                                   int key1) {
  int lo0 = lo, hi0 = hi, lo1 = lo, hi1 = hi;
  while (lo0 < hi0 || lo1 < hi1) {
    const int st0 = (hi0 - lo0 + kThreads - 1) / kThreads;
    const int st1 = (hi1 - lo1 + kThreads - 1) / kThreads;
    const int i0 = lo0 + threadIdx.x * st0;
    const int i1 = lo1 + threadIdx.x * st1;
    const int c0 = __syncthreads_count(i0 < hi0 && __ldg(a + i0) < key0);
    const int c1 = __syncthreads_count(i1 < hi1 && __ldg(a + i1) < key1);
    if (lo0 < hi0) {
      if (c0 == 0) {
        hi0 = lo0;
      } else {
        const int last = lo0 + (c0 - 1) * st0;  // the last sampled entry below key0
        hi0 = min(hi0, last + st0);
        lo0 = last + 1;
      }
    }
    if (lo1 < hi1) {
      if (c1 == 0) {
        hi1 = lo1;
      } else {
        const int last = lo1 + (c1 - 1) * st1;
        hi1 = min(hi1, last + st1);
        lo1 = last + 1;
      }
    }
  }
  return make_int2(lo0, lo1);
}

// acc += val * X[col] over the slots [s, e) of one row, the whole warp in lockstep: the warp holds
// 32 slots' (col, val) at a time, one a lane (the first 32 come in my_col, my_val, prefetched by
// the caller); team p takes the edges p * kGather + u of each round and keeps its kGather row
// gathers in flight before their adds.
template <typename T>
__device__ __forceinline__ void row_sum(const int* __restrict__ cols,
                                        const float* __restrict__ vals, const T* __restrict__ x,
                                        int s, int e, int d, int feat, int lane, int step,
                                        int team_off, int my_col, float my_val,
                                        float (&acc)[Lane<T>::kN]) {
  using L = Lane<T>;
  const bool active = feat < d;
  for (int t0 = s; t0 < e; t0 += kWarp) {
    if (t0 != s) {
      const int t = t0 + lane;
      my_col = t < e ? __ldg(cols + t) : 0;
      my_val = t < e ? L::round(__ldg(vals + t)) : 0.f;
    }
    const int n = min(kWarp, e - t0);
    for (int r0 = 0; r0 < n; r0 += step) {
      uint4 raw[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = r0 + team_off + u;
        const int col = __shfl_sync(kFull, my_col, j & (kWarp - 1));
        raw[u] = active && j < n
                     ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(col) * d + feat))
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = r0 + team_off + u;
        const float v = __shfl_sync(kFull, my_val, j & (kWarp - 1));
        if (active && j < n) L::add(acc, v, raw[u]);
      }
    }
  }
}

// Grid (n_windows, ceil(rb / kRowsPerCta)): CTA (w, y) writes the window rows y * 32 + i, i < 32,
// of out [n_windows * rb, d] (see the header).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4) fused_window_spmm_kernel(
    const int* __restrict__ wmap, const int* __restrict__ cols, const int* __restrict__ lrows,
    const float* __restrict__ vals, const T* __restrict__ x, float* __restrict__ out,
    int n_blocks, int eb, int rb, int d, int lanes_log2) {
  using L = Lane<T>;
  __shared__ int bounds[kRowsPerCta + 1];  // row r0 + k's slots: [bounds[k], bounds[k + 1])
  const int win = blockIdx.x;
  const int r0 = blockIdx.y * kRowsPerCta;
  const int nr = min(kRowsPerCta, rb - r0);
  // the window's blocks (the trailing pad blocks repeat the last window and hold pads only),
  // then the stretch of its slots that holds the rows [r0, r0 + nr)
  const int2 wb = cta_first_at_least(wmap, 0, n_blocks, win, win + 1);
  const int2 rs = cta_first_at_least(lrows, wb.x * eb, wb.y * eb, r0, r0 + nr);
  // slot t of the stretch starts the rows (lrows[t - 1], lrows[t]]; its end, the rows after
  for (int t = rs.x + threadIdx.x; t <= rs.y; t += kThreads) {
    const int prev = t == rs.x ? r0 - 1 : __ldg(lrows + t - 1);
    const int cur = t == rs.y ? r0 + nr : __ldg(lrows + t);
    for (int r = prev + 1; r <= cur; ++r) bounds[r - r0] = t;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int G = 1 << lanes_log2;  // lanes a team spreads one X row over
  const int q = lane & (G - 1);
  const int step = (kWarp >> lanes_log2) * kGather;
  const int team_off = (lane >> lanes_log2) * kGather;
  const int fw = G * L::kN;  // features one pass covers
  const int per = kRowsPerCta / kWarpsPerCta;
  const int lo = min(nr, warp * per);
  const int hi = min(nr, lo + per);
  float* o = out + (static_cast<int64_t>(win) * rb + r0) * d;
  for (int c0 = 0; c0 < d; c0 += fw) {
    const int feat = c0 + q * L::kN;
    int s = lo < hi ? bounds[lo] : 0;
    int e = lo < hi ? bounds[lo + 1] : 0;
    int pc = s + lane < e ? __ldg(cols + s + lane) : 0;
    float pv = s + lane < e ? L::round(__ldg(vals + s + lane)) : 0.f;
    for (int i = lo; i < hi; ++i) {
      const int cs = s, ce = e, my_col = pc;
      const float my_val = pv;
      if (i + 1 < hi) {
        s = bounds[i + 1];
        e = bounds[i + 2];
        pc = s + lane < e ? __ldg(cols + s + lane) : 0;
        pv = s + lane < e ? L::round(__ldg(vals + s + lane)) : 0.f;
      }
      float acc[L::kN] = {};
      row_sum<T>(cols, vals, x, cs, ce, d, feat, lane, step, team_off, my_col, my_val, acc);
      for (int off = G; off < kWarp; off <<= 1) {  // the teams' sums, the same tree every call
#pragma unroll
        for (int k = 0; k < L::kN; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
      }
      if (lane < G && feat < d) store(o + static_cast<int64_t>(i) * d + feat, acc);
    }
  }
}

template <typename T>
int launch_fused(const int* wmap, const int* cols, const int* lrows, const float* vals,
                 const void* x, float* out, int n_blocks, int n_windows, int eb, int rb, int d,
                 int lanes_log2, cudaStream_t stream) {
  if (n_windows <= 0 || rb <= 0) return 0;
  const dim3 grid(n_windows, (rb + kRowsPerCta - 1) / kRowsPerCta);
  fused_window_spmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      wmap, cols, lrows, vals, static_cast<const T*>(x), out, n_blocks, eb, rb, d, lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, allocate nothing, and return the
// cudaError_t of their launch (0 on success).
//
// hd_resident_row_gather: out [n_out, row_bytes] = x [n_src, row_bytes][idx]; row_bytes % 16 == 0,
// both 16-byte aligned.
extern "C" int hd_resident_row_gather(const int* idx, const void* x, void* out, int64_t n_out,
                                      int n_src, int row_bytes, void* stream) {
  if (n_out <= 0) return 0;
  const int64_t grid = (n_out + kWarpsPerCta - 1) / kWarpsPerCta;
  resident_row_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      idx, static_cast<const uint4*>(x), static_cast<uint4*>(out), n_out, n_src, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// hd_fused_window_spmm: out [n_windows * rb, d] f32, written whole, from the pack_blocked layout
// ([n_blocks, eb] cols, local_rows, vals; wmap [n_blocks]; n_blocks * eb < 2^31) and x [ncols, d],
// f32 or (x_bf16 != 0) bf16, 16-byte aligned; d % 32 == 0, d <= 256; `lanes_log2` is log2 of the
// lanes a team spreads one X row over (the wrapper's choice).
extern "C" int hd_fused_window_spmm(const int* wmap, const int* cols, const int* lrows,
                                    const float* vals, const void* x, int x_bf16, float* out,
                                    int n_blocks, int n_windows, int eb, int rb, int d,
                                    int lanes_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_fused<__nv_bfloat16>(wmap, cols, lrows, vals, x, out, n_blocks,
                                              n_windows, eb, rb, d, lanes_log2, s)
                : launch_fused<float>(wmap, cols, lrows, vals, x, out, n_blocks, n_windows, eb,
                                      rb, d, lanes_log2, s);
}
