// Row-window segment SpMM for Hopper (sm_90a): out = A @ X, X [ncols, d], out [nrows, d] f32.
//
// Replaces the TPU kernels of
// hypergraph_diffusion_for_recommendation_tpu/ops/pallas/segment_spmm.py:
//   segment_spmm_rows        <- _segment_matmul_kernel            (:356), base layout (pack_blocked)
//   segment_spmm_dedup       <- _segment_matmul_dedup_kernel      (:429), dedup layout
//                               (pack_blocked_dedup)
//   segment_spmm_rows_int8   <- _segment_matmul_int8_kernel       (:397), base layout, int8 X
//   segment_spmm_dedup_int8  <- _segment_matmul_dedup_int8_kernel (:475), dedup layout, int8 X
// segment_spmm_rows_int8 runs on the base kernel's work lists with a kernel of its own that sums
// in integers and dequantises as it writes; segment_spmm_dedup_int8 runs on the dedup kernel's
// parts and work lists and dequantises as it writes. Both take X quantised on the card by
// quantize_int8 (two launches), the port of the XLA ops of the int8 branches (:569-571,
// :596-598). The bf16 form of segment_spmm_dedup runs on the tensor cores
// (segment_spmm_dedup_mma_kernel). Python binding, checks, the work lists and the plain
// versions: ops/kernels/segment_spmm.py.
//
// What bounds them on the H100. The work is one multiply-add per edge and feature (2 * nnz * d
// FLOP), while each call must read the indices and values (8 B per edge in the base layout,
// 12 B in the dedup layout), the X rows in use and write the output (nrows * d * 4 B); by that
// count all four are bound by bytes. At the main-path shapes (2500-19664 rows, d = 128) the
// table and the output are a few MB and sit in the 50 MB L2, and what limits the kernels is
// different: the base kernel by the rate of row gathers out of the L2 (nnz * d * 2 B in bf16,
// 43-76 MB a call), the dedup kernel by the per-block latency of its staging pipeline.
//
// Design, against that:
//  * Base kernel (segment_spmm_rows): every output row is written exactly once, by one writer,
//    with no atomics and no zero fill, so two calls give the same bits. A lane reads 16 B of an
//    X row (4 f32 or 8 bf16 features), so a team of G lanes (a power of
//    two <= 32) covers a row: at d = 128 a bf16 row is half a warp. The whole warp works on one
//    row at a time, in lockstep: its teams take alternate groups of kGather edges, each team
//    keeps kGather row gathers in flight, and at the row's end the teams' sums are added by a
//    fixed shuffle tree. (Teams on different rows would diverge and run one after the other.)
//    The packer's work list (`warp_rows`) gives each warp of a 256-thread CTA at most
//    ROWS_PER_WARP consecutive rows (empty ones included, so they come out zero) of at most
//    ROW_SLOTS slots in all, and lists the CTAs costliest first (a short tail); the next row's first 32 slots load while this row's gathers are in
//    flight. A row longer than ROW_SLOTS (a hub row: up to 600 edges at these shapes) gets a CTA
//    of its own: its 8 warps each sum an eighth of the row, and the CTA adds the warps' sums in
//    warp order through shared memory and writes the row once. 64 registers a thread (launch
//    bounds): 4 CTAs, 32 warps an SM.
//  * Dedup kernel (segment_spmm_dedup): the dedup layout sorts a window's edges by column and
//    closes a block at eb edges or ub distinct columns. At ML-1M density a block has some
//    10-25 distinct columns for its 512 edges, so staging them reads a small fraction of the
//    base layout's L2 bytes. A CTA of 512 threads takes one part of a row window's blocks (the
//    wrapper cuts the blocks into as many parts of near-equal cost as the SMs hold at once: the
//    windows differ several-fold in blocks and in distinct columns) and one feature slice, and
//    walks its blocks through a cp.async pipeline one block ahead (the block's distinct X row
//    slices, its slots in the packer's (row % 16, row, slot) order and their values; the
//    indices two blocks ahead). Warp w owns the window rows r with r % 16 == w, whose slots are
//    consecutive in that order, and keeps their sums in registers: no atomics of any kind, a
//    fixed order, one CTA-wide barrier a block. In bf16 (the main path) the warp writes its rows' W[r, u] (each
//    (row, column) run's values rounded and summed, then rounded) into its own [16, 64] bf16 W
//    tile in shared memory and multiplies it by the staged rows with mma.sync m16n8k16 (f32
//    accumulators): the TPU kernel's W x X on the tensor cores, 16 distinct columns a step. In
//    f32 it adds each run's W[r, u] * X[u] with f32 multiply-adds. A window of one part writes
//    its rows straight to the output; the parts of a split window write [rb, d] tiles to an f32
//    scratch that a second pass (segment_spmm_dedup_sum_parts_kernel) adds in part order.
//  * bf16 mode rounds where the TPU kernels round: the X table arrives as bf16 (the wrapper
//    casts it once), each edge value is rounded to bf16, the dedup weight W[r, u] (the f32 sum of
//    a block's bf16-rounded values with that row and distinct column, consecutive slots in the
//    packer's order) is rounded to bf16, and every product and sum is f32.
//  * int8 mode follows the TPU int8 kernels: X is quantised per column
//    (q = clip(round(X / s), +-127), s = max(max|X| / 127, 1e-12)), the kernels gather int8 rows,
//    round each edge value and the dedup weight W to bf16 whatever the bf16 flag says, and scale
//    each finished sum, rounded to f32, by s. Where the TPU kernel sums in f32, these sum
//    exactly: every product bf16 x int8 is exact, and so is a sum of them held in f64 or in
//    integers, whatever its order. In f32 that order changes the last bit of a sum, which the
//    next product's quantisation can turn into a whole int8 step (and in the backward, where g is
//    quantised per column, into a visible change of a gradient); exact, the kernels and the plain
//    version (f64 sums) agree bit for bit and training in int8 mode repeats exactly: the f32
//    rounding of an exact sum does not depend on how it was formed.
//  * segment_spmm_rows_int8 (kernel 3) walks the base kernel's work lists (warp_rows, the same
//    hub CTAs, the same costliest-first CTA order and next-row prefetch) in a kernel of its own,
//    with no f64 scratch and no dequantisation pass: each output row's one writer stores it
//    dequantised. A lane gathers 16 B of a q row (16 features), so a team of G lanes covers a
//    row (8 lanes at d = 128: 4 teams a warp, 3 gathers each in flight). It sums in integers:
//    each bf16 edge value is m * 2^e (m its 8-bit significand with the sign), t = the least e of
//    the warp's slots, W = m << (e - t), and every element is one dp2a (W in an int16 half of
//    one operand times a sign-extended byte of the q row, added to an int32): no conversion, no
//    f64. That is exact while W fits int16 (span = the greatest e less t at most 7) and the
//    int32 sum holds at most kSumSlots = 512 slots (255 * 127 * 512 * 2^7 < 2^31); the
//    main-path matrices' rows span at most 4. A row of a normal warp has at most row_slots <=
//    512 slots; a hub warp sums its share in chunks of 512 slots, each flushed exactly to f64.
//    A warp whose values span more than 7 binades (or hold an inf or a nan) takes f64 sums, 4
//    features a pass from 4-byte gathers (8 spill and slow the integer path), exact while its
//    values span some 25 binades. The teams' integer sums meet by a reduce-scatter over the
//    team bits (the same shuffles every call), after which each lane holds G / 2 of the row's
//    sums and the warp writes f32(S * 2^t) * s[col] coalesced (one int->f32 conversion and two
//    multiplies; through f64 where 2^t or the result would leave f32's normal range). A hub
//    CTA's warps each decide for their own share and write its exact sum as f64 to shared
//    memory, added in warp order and dequantised once. No atomics, one writer a row: two calls
//    give the same bits. What bounds it at the main-path shapes: the issue of its instructions
//    and the latency of its gathers with 32 warps an SM (64 registers at d 33-128; the other
//    widths take 80), not bytes.
//  * The quantisation (quantize_int8, the wrapper's before either int8 kernel): two launches in
//    place of six torch passes. column_amax_kernel takes the column maxima |X| of row chunks into
//    a small partial table; quantise_kernel CTAs each reduce that table (the same maxima in any
//    order: max is exact), form s with an IEEE f32 division (__fdiv_rn, not a reciprocal, as the
//    plain version and JAX divide) and write q = clamp(rint(x / s)) for a chunk of rows, rint
//    rounding half to even as torch.round. It equals the plain quantize_int8 bit for bit. Bound:
//    bytes (X read, q written: 1.6 MB at ML-1M density, 0.5 us); at these sizes each launch is a
//    few microseconds of latency (a one-launch form across a grid-wide barrier measured slower
//    on the H100: PERF.md).
//  * segment_spmm_dedup_int8 runs on the dedup kernel's structure: the same parts of near-equal
//    cost (dedup_parts with dedup_int8_block_cost: per block the staging plus its live slots,
//    since its CUDA-core walk costs per slot, not per 16 distinct columns as the mma kernel), the
//    same work lists (order_rc, order_slot, block_meta) and cp.async pipeline one block ahead
//    (a block's distinct int8 row slices, 64 B each, its ordered codes and values). Per block the
//    CTA widens the staged rows to f64 once (a [ub, 64] f64 tile) and forms each (row, column)
//    run's W[r, u]: its bf16-rounded values summed in f32 in slot order, then rounded to bf16.
//    Warp w owns the window rows r % 16 == w and keeps their f64 sums in registers, 64 features
//    a CTA (two a lane); each run adds W[r, u] * q[u] with two f64 multiply-adds, exact. No
//    atomics, no zero fill, one writer a value: a window of one part writes its dequantised rows
//    straight to the output (f32(sum) * s, as the plain version computes it); the parts of
//    a split window write [rb, d] f64 tiles to a scratch that a second pass sums in part order
//    and dequantises as it writes. Its f64 sums take some 128 registers a thread: one 512-thread
//    CTA an SM. What bounds it: not bytes but the instructions of the walk (per run a shuffle
//    broadcast of the column and of W, a shared load, two f64 multiply-adds; per 32 runs of a
//    warp, 16 row groups' bounds) and the block's two barriers, with only 16 warps an SM to hide
//    their latency; then the f64 scratch of split windows (parts x rb x d x 8 B, written once and
//    read once by the second pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerCta = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A lane's share of an X row in the base kernel: kN features read as one Raw load, kGather such
// loads in flight; add() multiplies them by an edge value into the accumulators; round() rounds
// an edge value as the TPU kernel does.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static constexpr int kGather = 4;  // X rows a team keeps in flight (a team is the whole warp)
  static constexpr int kMinBlocks = 4;  // CTAs an SM holds: 64 registers a thread
  using Raw = uint4;
  using Acc = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void add(float (&acc)[kN], float v, const Raw& r) {
    acc[0] = fmaf(v, __uint_as_float(r.x), acc[0]);
    acc[1] = fmaf(v, __uint_as_float(r.y), acc[1]);
    acc[2] = fmaf(v, __uint_as_float(r.z), acc[2]);
    acc[3] = fmaf(v, __uint_as_float(r.w), acc[3]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

__device__ __forceinline__ float2 bf16x2(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static constexpr int kGather = 4;  // X rows a team keeps in flight (two teams a warp at d 128)
  static constexpr int kMinBlocks = 4;
  using Raw = uint4;
  using Acc = float;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void add(float (&acc)[kN], float v, const Raw& r) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = bf16x2(w[k]);
      acc[2 * k] = fmaf(v, f.x, acc[2 * k]);
      acc[2 * k + 1] = fmaf(v, f.y, acc[2 * k + 1]);
    }
  }
  static __device__ __forceinline__ float round(float v) { return bf16_round(v); }
};

__device__ __forceinline__ void store(float* o, const float (&a)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store(float* o, const float (&a)[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// acc += val * X[col] over the slots [s, e) of one row, the whole warp in lockstep: the warp
// holds 32 slots' (col, val) at a time, one a lane (the first 32 come in my_col, my_val,
// prefetched by the caller); team p of the warp's P takes the edges p * kGather + u of each
// round of P * kGather and keeps its kGather row gathers in flight before their multiply-adds.
// Each team adds its edges in slot order; reduce_teams then combines the teams in a fixed order.
template <typename T>
__device__ __forceinline__ void row_sum(const int* __restrict__ cols,
                                        const float* __restrict__ vals,
                                        const T* __restrict__ x, int s, int e, int d, int feat,
                                        int lane, int step, int team_off, int my_col,
                                        float my_val, typename Vec<T>::Acc (&acc)[Vec<T>::kN]) {
  using V = Vec<T>;
  constexpr int kGather = V::kGather;
  const bool active = feat < d;
  for (int t0 = s; t0 < e; t0 += kWarp) {
    if (t0 != s) {
      const int t = t0 + lane;
      my_col = t < e ? __ldg(cols + t) : 0;
      my_val = t < e ? V::round(__ldg(vals + t)) : 0.f;
    }
    const int n = min(kWarp, e - t0);
    for (int r0 = 0; r0 < n; r0 += step) {
      typename V::Raw raw[kGather] = {};
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = r0 + team_off + u;
        const int col = __shfl_sync(kFull, my_col, j & (kWarp - 1));
        if (active && j < n) raw[u] = V::load(x + static_cast<int64_t>(col) * d + feat);
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = r0 + team_off + u;
        const float v = __shfl_sync(kFull, my_val, j & (kWarp - 1));
        if (active && j < n) V::add(acc, v, raw[u]);
      }
    }
  }
}

// the teams' sums added across the warp (lanes G, 2G, ... apart), the same tree every call
template <typename A, int N>
__device__ __forceinline__ void reduce_teams(A (&acc)[N], int G) {
  for (int off = G; off < kWarp; off <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
}

// The base kernel (see the header). CTA c's warp w takes the rows [warp_rows[c][w],
// warp_rows[c][w + 1]) (at most 32); a CTA whose warp 0 holds one row of more than
// `row_slots` slots is a hub CTA, whose 8 warps each sum an eighth of that row. Row r's slots
// are the flat range [row_start[r], row_end[r]) of the [n_blocks * eb] slot arrays.
template <typename T>
__global__ void __launch_bounds__(kThreads, Vec<T>::kMinBlocks) segment_spmm_rows_kernel(
    const int* __restrict__ warp_rows, const int* __restrict__ row_start,
    const int* __restrict__ row_end, const int* __restrict__ cols, const float* __restrict__ vals,
    const T* __restrict__ x, typename Vec<T>::Acc* __restrict__ out, int d, int lanes_log2,
    int row_slots) {
  using V = Vec<T>;
  using Acc = typename V::Acc;
  constexpr int kN = V::kN;
  __shared__ Acc part[kThreads * kN];  // a hub row's per-warp sums, [8, G * kN]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int G = 1 << lanes_log2;  // lanes a team spreads one X row over
  const int q = lane & (G - 1);
  const int step = (kWarp >> lanes_log2) * V::kGather;
  const int team_off = (lane >> lanes_log2) * V::kGather;
  const int fw = G * kN;  // features one pass covers
  const int* wr = warp_rows + blockIdx.x * (kWarpsPerCta + 1);  // this CTA's warps' rows
  const int first = wr[0];

  if (wr[1] == first + 1 && row_end[first] - row_start[first] > row_slots) {
    // hub CTA: warp w sums the w-th eighth of the row; the warps' sums meet in shared memory
    const int s = row_start[first];
    const int len = row_end[first] - s;
    const int ws = s + static_cast<int>(static_cast<int64_t>(len) * warp / kWarpsPerCta);
    const int we = s + static_cast<int>(static_cast<int64_t>(len) * (warp + 1) / kWarpsPerCta);
    for (int c0 = 0; c0 < d; c0 += fw) {
      const int feat = c0 + q * kN;
      const int t = ws + lane;
      Acc acc[kN] = {};
      row_sum<T>(cols, vals, x, ws, we, d, feat, lane, step, team_off,
                 t < we ? __ldg(cols + t) : 0, t < we ? V::round(__ldg(vals + t)) : 0.f, acc);
      reduce_teams(acc, G);
      if (lane < G) {
#pragma unroll
        for (int k = 0; k < kN; ++k) part[warp * fw + q * kN + k] = acc[k];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < fw && c0 + i < d; i += kThreads) {
        Acc sum = part[i];
        for (int k = 1; k < kWarpsPerCta; ++k) sum += part[k * fw + i];
        out[static_cast<int64_t>(first) * d + c0 + i] = sum;
      }
      __syncthreads();
    }
    return;
  }

  // the warp's rows one after another, each summed by the whole warp; the next row's first
  // slots load while this row's gathers are in flight
  const int lo = wr[warp];
  const int nr = wr[warp + 1] - lo;
  const int my_s = lane < nr ? row_start[lo + lane] : 0;  // row lo + lane's slot range
  const int my_e = lane < nr ? row_end[lo + lane] : 0;
  for (int c0 = 0; c0 < d; c0 += fw) {
    const int feat = c0 + q * kN;
    int s = __shfl_sync(kFull, my_s, 0);
    int e = __shfl_sync(kFull, my_e, 0);
    int pc = 0;
    float pv = 0.f;
    if (nr > 0 && s + lane < e) {
      pc = __ldg(cols + s + lane);
      pv = V::round(__ldg(vals + s + lane));
    }
    for (int i = 0; i < nr; ++i) {
      const int cs = s, ce = e, my_col = pc;
      const float my_val = pv;
      if (i + 1 < nr) {
        s = __shfl_sync(kFull, my_s, i + 1);
        e = __shfl_sync(kFull, my_e, i + 1);
        pc = s + lane < e ? __ldg(cols + s + lane) : 0;
        pv = s + lane < e ? V::round(__ldg(vals + s + lane)) : 0.f;
      }
      Acc acc[kN] = {};
      row_sum<T>(cols, vals, x, cs, ce, d, feat, lane, step, team_off, my_col, my_val, acc);
      reduce_teams(acc, G);
      if (lane < G && feat < d) store(out + static_cast<int64_t>(lo + i) * d + feat, acc);
    }
  }
}

// ---- kernel 3, the int8 base kernel (see the header): integer sums, dequantised as it writes ----
constexpr int kQ = 16;        // int8 features a lane gathers: one 16-byte load
constexpr int kQGather = 3;   // q rows a team keeps in flight (4 spill at 64 registers)
constexpr int kMaxSpan = 7;     // binades the integer path takes: |W| < 2^15 (dp2a's int16)
constexpr int kSumSlots = 512;  // slots an int32 sum takes: 255 * 127 * 512 * 2^kMaxSpan < 2^31
constexpr int kF64Feats = 4;    // features a lane sums in one pass of the f64 path (8 spill)

// the team shape at 2^LG lanes a q row (FW = 16 * 2^LG features a pass; d > 512 takes several
// passes): P teams a warp, each lane holding NV of the row's sums after the reduce-scatter. At
// d 33-128 (LG 2, 3: the main path's 128) the kernel fits 64 registers, 4 CTAs an SM; the other
// widths spill there and take 80, 3 CTAs an SM.
template <int LG>
struct Team {
  static constexpr int G = 1 << LG;
  static constexpr int P = kWarp / G;
  static constexpr int NV = G / 2;
  static constexpr int FW = G * kQ;
  static constexpr int kStep = P * kQGather;  // slots a round of the warp takes
  static constexpr int kMinBlocks = LG == 2 || LG == 3 ? 4 : 3;
};

// a bf16-rounded edge value (f32 bits b) is mag * 2^(key - 134), mag its significand with the
// leading bit (0 for a zero), key = max(biased exponent, 1); key 255: inf or nan
__device__ __forceinline__ int edge_mag(unsigned b) {
  return ((b >> 16) & 0x7f) | (b & 0x7f800000u ? 0x80 : 0);
}
__device__ __forceinline__ int edge_key(unsigned b) { return max(static_cast<int>((b >> 23) & 0xff), 1); }

// the integer weight of the value: W = +-mag << (key - lo), lo the least key of the warp's slots
__device__ __forceinline__ int edge_weight(unsigned b, int lo) {
  const int mag = edge_mag(b);
  const int w = mag ? mag << (edge_key(b) - lo) : 0;
  return (b >> 31) ? -w : w;
}

__device__ __forceinline__ double pow2d(int t) {  // 2^t, -1022 <= t <= 1023
  return __longlong_as_double(static_cast<long long>(t + 1023) << 52);
}

// acc += W * q[col] over one batch of at most 32 slots, held one a lane (my_col, my_w: 0
// beyond the batch's n), the whole warp in lockstep: team p takes the slots p * kQGather + u of
// each round and keeps its kQGather 16-byte gathers in flight before the adds. One dp2a an
// element: W in one int16 half of its operand times a sign-extended byte of the q row.
template <int LG>
__device__ __forceinline__ void int8_batch(const int8_t* __restrict__ x, int n, int d, int feat,
                                           bool active, int team_off, int my_col, int my_w,
                                           int (&acc)[kQ]) {
  for (int r0 = 0; r0 < n; r0 += Team<LG>::kStep) {
    uint4 raw[kQGather];
#pragma unroll
    for (int u = 0; u < kQGather; ++u) {
      const int j = r0 + team_off + u;
      const int col = __shfl_sync(kFull, my_col, j & (kWarp - 1));
      raw[u] = make_uint4(0, 0, 0, 0);
      if (active && j < n) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(col) * d + feat));
      }
    }
#pragma unroll
    for (int u = 0; u < kQGather; ++u) {
      const int w = __shfl_sync(kFull, my_w, (r0 + team_off + u) & (kWarp - 1));
      const int lo = w & 0xffff;  // (W, 0) as int16 halves
      const int hi = w << 16;     // (0, W)
      const int wd[4] = {static_cast<int>(raw[u].x), static_cast<int>(raw[u].y),
                         static_cast<int>(raw[u].z), static_cast<int>(raw[u].w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[4 * i + 0] = __dp2a_lo(lo, wd[i], acc[4 * i + 0]);
        acc[4 * i + 1] = __dp2a_lo(hi, wd[i], acc[4 * i + 1]);
        acc[4 * i + 2] = __dp2a_hi(lo, wd[i], acc[4 * i + 2]);
        acc[4 * i + 3] = __dp2a_hi(hi, wd[i], acc[4 * i + 3]);
      }
    }
  }
}

// the f64 path's batch: acc += v * q[col] over the features feat .. feat + 4 (4-byte gathers)
template <int LG>
__device__ __forceinline__ void f64_batch(const int8_t* __restrict__ x, int n, int d, int feat,
                                          bool active, int team_off, int my_col, float my_val,
                                          double (&acc)[kF64Feats]) {
  for (int r0 = 0; r0 < n; r0 += Team<LG>::kStep) {
    int raw[kQGather];
#pragma unroll
    for (int u = 0; u < kQGather; ++u) {
      const int j = r0 + team_off + u;
      const int col = __shfl_sync(kFull, my_col, j & (kWarp - 1));
      raw[u] = 0;
      if (active && j < n) {
        raw[u] = __ldg(reinterpret_cast<const int*>(x + static_cast<int64_t>(col) * d + feat));
      }
    }
#pragma unroll
    for (int u = 0; u < kQGather; ++u) {
      const double v = __shfl_sync(kFull, my_val, (r0 + team_off + u) & (kWarp - 1));
#pragma unroll
      for (int k = 0; k < kF64Feats; ++k) {
        acc[k] = fma(v, static_cast<double>(static_cast<signed char>(raw[u] >> (8 * k))), acc[k]);
      }
    }
  }
}

// one level of the reduce-scatter over the teams: lanes `off` apart (teams differing in one
// bit) each keep one half of their 2 H sums, the lower half in the team whose bit is 0
template <int H>
__device__ __forceinline__ void scatter_level(int (&acc)[kQ], int off, bool upper) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const int send = upper ? acc[k] : acc[k + H];
    const int keep = upper ? acc[k + H] : acc[k];
    acc[k] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// the teams' sums, reduce-scattered over the team bits: lane (team p, position q) ends with the
// warp's sums of its team's features team_sub(p) .. + NV in acc[0 .. NV) (the same shuffles
// every call)
template <int LG>
__device__ __forceinline__ void reduce_scatter(int (&acc)[kQ], int team) {
  if constexpr (LG < 5) scatter_level<8>(acc, 1 << LG, team & 1);
  if constexpr (LG < 4) scatter_level<4>(acc, 2 << LG, (team >> 1) & 1);
  if constexpr (LG < 3) scatter_level<2>(acc, 4 << LG, (team >> 2) & 1);
  if constexpr (LG < 2) scatter_level<1>(acc, 8 << LG, (team >> 3) & 1);
}
template <int LG>
__device__ __forceinline__ int team_sub(int team) {
  int sub = 0;
  if constexpr (LG < 5) sub += (team & 1) * 8;
  if constexpr (LG < 4) sub += ((team >> 1) & 1) * 4;
  if constexpr (LG < 3) sub += ((team >> 2) & 1) * 2;
  if constexpr (LG < 2) sub += (team >> 3) & 1;
  return sub;
}

// the f64 path's teams added across the warp (lanes G, 2G, ... apart), the same tree every call
template <int LG>
__device__ __forceinline__ void reduce_teams_f64(double (&acc)[kF64Feats]) {
#pragma unroll
  for (int off = Team<LG>::G; off < kWarp; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kF64Feats; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
}

// the f64 path of warp_sums: 4 features a pass, each pass's sums handed to f64_out(h, acc) in
// the lanes of team 0
template <int LG, typename F64Out>
__device__ __forceinline__ void f64_sums(const int* __restrict__ cols,
                                         const float* __restrict__ vals,
                                         const int8_t* __restrict__ xq, int s, int n, int d,
                                         int feat, bool active, int team, int lane, int col0,
                                         unsigned b0, int col1, unsigned b1, F64Out f64_out) {
  const int team_off = team * kQGather;
  for (int h = 0; h < kQ; h += kF64Feats) {
    double acc[kF64Feats] = {};
    f64_batch<LG>(xq, min(n, kWarp), d, feat + h, active, team_off, col0, __uint_as_float(b0), acc);
    if (n > kWarp) {
      f64_batch<LG>(xq, min(n, 2 * kWarp) - kWarp, d, feat + h, active, team_off, col1,
                    __uint_as_float(b1), acc);
    }
    for (int t0 = s + 2 * kWarp; t0 < s + n; t0 += kWarp) {
      const int ti = t0 + lane;
      const int col = ti < s + n ? __ldg(cols + ti) : 0;
      const float v = ti < s + n ? bf16_round(__ldg(vals + ti)) : 0.f;
      f64_batch<LG>(xq, min(kWarp, s + n - t0), d, feat + h, active, team_off, col, v, acc);
    }
    reduce_teams_f64<LG>(acc);
    if (team == 0) f64_out(h, acc);
  }
}

// The sums of one warp's n slots [s, s + n) (a row, or a hub warp's share of one) over the
// features of this pass. The integer path (returns true): the reduce-scattered sums S and t, the
// sum being S * 2^t; a hub warp (kHub) hands each chunk of kSumSlots slots to flush(S, t,
// first) instead (a normal warp's row, at most kSumSlots slots, is one chunk). The f64 path:
// f64_sums. The first 32 slots come in (col0, b0: the f32 bits of the bf16-rounded value),
// prefetched by the caller.
template <int LG, bool kHub, typename Flush, typename F64Out>
__device__ __forceinline__ bool warp_sums(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          const int8_t* __restrict__ xq, int s, int n, int d,
                                          int feat, bool active, int team, int lane, int col0,
                                          unsigned b0, int (&sums)[kQ], int& t, Flush flush,
                                          F64Out f64_out) {
  const int team_off = team * kQGather;
  int col1 = 0;  // slots 32 .. 63
  unsigned b1 = 0;
  if (n > kWarp && kWarp + lane < n) {
    col1 = __ldg(cols + s + kWarp + lane);
    b1 = __float_as_uint(bf16_round(__ldg(vals + s + kWarp + lane)));
  }
  // the least and greatest exponent keys of the nonzero values (255 and 0 if all are zero)
  int lo = edge_mag(b0) ? edge_key(b0) : 255;
  int hi = edge_mag(b0) ? edge_key(b0) : 0;
  if (n > kWarp && edge_mag(b1)) {
    lo = min(lo, edge_key(b1));
    hi = max(hi, edge_key(b1));
  }
  for (int ti = s + 2 * kWarp + lane; ti < s + n; ti += kWarp) {  // beyond 64 slots: a hub share
    const unsigned b = __float_as_uint(bf16_round(__ldg(vals + ti)));
    if (edge_mag(b)) {
      lo = min(lo, edge_key(b));
      hi = max(hi, edge_key(b));
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  t = lo - 134;
  if ((lo == 255 && hi == 0) || (hi < 255 && hi - lo <= kMaxSpan)) {
    // slots [c0, c1) loaded a batch of 32 at a time, from c0 = 64 on (the first two batches
    // come in col0, b0 and col1, b1)
    const auto batches = [&](int c0, int c1) {
      for (int t0 = s + c0; t0 < s + c1; t0 += kWarp) {
        const int ti = t0 + lane;
        int col = 0, w = 0;
        if (ti < s + c1) {
          col = __ldg(cols + ti);
          w = edge_weight(__float_as_uint(bf16_round(__ldg(vals + ti))), lo);
        }
        int8_batch<LG>(xq, min(kWarp, s + c1 - t0), d, feat, active, team_off, col, w, sums);
      }
    };
#pragma unroll
    for (int k = 0; k < kQ; ++k) sums[k] = 0;
    const int w1 = edge_weight(b1, lo);
    const int end = kHub ? min(n, kSumSlots) : n;
    int8_batch<LG>(xq, min(n, kWarp), d, feat, active, team_off, col0, edge_weight(b0, lo), sums);
    if (n > kWarp) int8_batch<LG>(xq, min(n, 2 * kWarp) - kWarp, d, feat, active, team_off, col1, w1, sums);
    batches(2 * kWarp, end);
    reduce_scatter<LG>(sums, team);
    if constexpr (kHub) {
      flush(sums, t, true);
      for (int c = kSumSlots; c < n; c += kSumSlots) {  // a long share: the next chunk, exact anew
#pragma unroll
        for (int k = 0; k < kQ; ++k) sums[k] = 0;
        batches(c, min(n, c + kSumSlots));
        reduce_scatter<LG>(sums, team);
        flush(sums, t, false);
      }
    }
    return true;
  }
  f64_sums<LG>(cols, vals, xq, s, n, d, feat, active, team, lane, col0, b0, col1, b1, f64_out);
  return false;
}

// Kernel 3 (see the header): out = (A @ (q * s)) over the base layout's work lists, q [ncols, d]
// int8, s [d], 2^LG lanes a team; CTA c's warp w takes the rows [warp_rows[c][w],
// warp_rows[c][w + 1]), a hub CTA one row of more than row_slots slots. Dynamic shared memory:
// [8, FW] f64, a hub row's per-warp sums.
template <int LG>
__global__ void __launch_bounds__(kThreads, Team<LG>::kMinBlocks) segment_spmm_rows_int8_kernel(
    const int* __restrict__ warp_rows, const int* __restrict__ row_start,
    const int* __restrict__ row_end, const int* __restrict__ cols, const float* __restrict__ vals,
    const int8_t* __restrict__ xq, const float* __restrict__ scale, float* __restrict__ out,
    int d, int row_slots) {
  using T = Team<LG>;
  extern __shared__ double part[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int q = lane & (T::G - 1);
  const int team = lane >> LG;
  const int sub = team_sub<LG>(team);  // the lane's first feature of the team's 16 after the scatter
  const int* wr = warp_rows + blockIdx.x * (kWarpsPerCta + 1);
  const int first = wr[0];
  int sums[kQ];
  int t;

  if (wr[1] == first + 1 && row_end[first] - row_start[first] > row_slots) {
    // hub CTA: warp w sums the w-th eighth of the row with its own exponent; the warps' exact
    // sums meet in f64 in shared memory, added in warp order
    const int s = row_start[first];
    const int len = row_end[first] - s;
    const int ws = s + static_cast<int>(static_cast<int64_t>(len) * warp / kWarpsPerCta);
    const int we = s + static_cast<int>(static_cast<int64_t>(len) * (warp + 1) / kWarpsPerCta);
    double* mine = part + warp * T::FW + q * kQ;
    for (int c0 = 0; c0 < d; c0 += T::FW) {
      const int feat = c0 + q * kQ;
      const int col0 = ws + lane < we ? __ldg(cols + ws + lane) : 0;
      const unsigned b0 = ws + lane < we ? __float_as_uint(bf16_round(__ldg(vals + ws + lane))) : 0u;
      warp_sums<LG, true>(
          cols, vals, xq, ws, we - ws, d, feat, feat < d, team, lane, col0, b0, sums, t,
          [&](const int(&chunk)[kQ], int t2, bool first) {  // S * 2^t and its sum: exact
            const double p2 = pow2d(t2);
#pragma unroll
            for (int k = 0; k < T::NV; ++k) {
              const double v = __int2double_rn(chunk[k]) * p2;
              mine[sub + k] = first ? v : mine[sub + k] + v;
            }
          },
          [mine](int h, const double(&acc)[kF64Feats]) {
#pragma unroll
            for (int k = 0; k < kF64Feats; ++k) mine[h + k] = acc[k];
          });
      __syncthreads();
      for (int i = threadIdx.x; i < T::FW && c0 + i < d; i += kThreads) {
        double sum = part[i];
        for (int k = 1; k < kWarpsPerCta; ++k) sum += part[k * T::FW + i];
        out[static_cast<int64_t>(first) * d + c0 + i] =
            __double2float_rn(sum) * __ldg(scale + c0 + i);
      }
      __syncthreads();
    }
    return;
  }

  // the warp's rows one after another, each summed by the whole warp; the next row's first
  // 32 slots load while this row's gathers are in flight
  const int lo = wr[warp];
  const int nr = wr[warp + 1] - lo;
  const int my_s = lane < nr ? row_start[lo + lane] : 0;  // row lo + lane's slot range
  const int my_e = lane < nr ? row_end[lo + lane] : 0;
  for (int c0 = 0; c0 < d; c0 += T::FW) {
    const int feat = c0 + q * kQ;
    const bool active = feat < d;
    int s = __shfl_sync(kFull, my_s, 0);
    int e = __shfl_sync(kFull, my_e, 0);
    int pc = 0;
    unsigned pb = 0;
    if (nr > 0 && s + lane < e) {
      pc = __ldg(cols + s + lane);
      pb = __float_as_uint(bf16_round(__ldg(vals + s + lane)));
    }
    for (int i = 0; i < nr; ++i) {
      const int cs = s, n = e - s, col0 = pc;
      const unsigned b0 = pb;
      if (i + 1 < nr) {
        s = __shfl_sync(kFull, my_s, i + 1);
        e = __shfl_sync(kFull, my_e, i + 1);
        pc = s + lane < e ? __ldg(cols + s + lane) : 0;
        pb = s + lane < e ? __float_as_uint(bf16_round(__ldg(vals + s + lane))) : 0u;
      }
      float* orow = out + static_cast<int64_t>(lo + i) * d;
      const bool fast = warp_sums<LG, false>(
          cols, vals, xq, cs, n, d, feat, active, team, lane, col0, b0, sums, t,
          [](const int(&)[kQ], int, bool) {},
          [active, scale, feat, orow](int h, const double(&acc)[kF64Feats]) {
            if (!active) return;
            const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + feat + h));
            *reinterpret_cast<float4*>(orow + feat + h) = make_float4(
                __double2float_rn(acc[0]) * s4.x, __double2float_rn(acc[1]) * s4.y,
                __double2float_rn(acc[2]) * s4.z, __double2float_rn(acc[3]) * s4.w);
          });
      if (fast && active) {
        // f32(S * 2^t) * s: one int->f32 conversion and an exact power-of-two multiply where
        // 2^t and the result are normal f32 (|S| < 2^31), else through f64
        float r[T::NV];
        float sc[T::NV];  // the scales of the lane's NV output features
        if constexpr (T::NV >= 4) {
#pragma unroll
          for (int k = 0; k < T::NV; k += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(scale + feat + sub + k));
            sc[k] = v.x;
            sc[k + 1] = v.y;
            sc[k + 2] = v.z;
            sc[k + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < T::NV; ++k) sc[k] = __ldg(scale + feat + sub + k);
        }
        if (t >= -126 && t <= 96) {
          const float p2 = __int_as_float((t + 127) << 23);
#pragma unroll
          for (int k = 0; k < T::NV; ++k) r[k] = __fmul_rn(__int2float_rn(sums[k]), p2) * sc[k];
        } else {
          const double p2 = pow2d(t);
#pragma unroll
          for (int k = 0; k < T::NV; ++k) {
            r[k] = __double2float_rn(__int2double_rn(sums[k]) * p2) * sc[k];
          }
        }
        float* o = orow + feat + sub;
        if constexpr (T::NV >= 4) {
#pragma unroll
          for (int k = 0; k < T::NV; k += 4) {
            *reinterpret_cast<float4*>(o + k) = make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
          }
        } else if constexpr (T::NV == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
        } else {
          o[0] = r[0];
        }
      }
    }
  }
}

template <int LG>
int launch_rows_int8(const int* warp_rows, const int* row_start, const int* row_end,
                     const int* cols, const float* vals, const int8_t* xq, const float* scale,
                     float* out, int n_ctas, int d, int row_slots, cudaStream_t stream) {
  const int smem = kWarpsPerCta * Team<LG>::FW * static_cast<int>(sizeof(double));
  segment_spmm_rows_int8_kernel<LG><<<n_ctas, kThreads, smem, stream>>>(
      warp_rows, row_start, row_end, cols, vals, xq, scale, out, d, row_slots);
  return static_cast<int>(cudaGetLastError());
}

// ---- the dedup kernel (see the header): grid (n_parts, feature slices) ----
constexpr int kDedupWarps = 16;
constexpr int kDedupThreads = kDedupWarps * kWarp;
constexpr int kRowsPerWarp = 16;  // warp w sums the window rows s * 16 + w, s < 16 (rb <= 256)
constexpr int kGroups = kDedupWarps * kRowsPerWarp;  // (warp, s) groups of a block's slots
constexpr int kMetaWidth = kGroups + 2;  // block_meta row: kGroups + 1 offsets, then n_unique
constexpr int kMetaPad = 260;            // ints the staged meta row takes (16-byte multiple)

constexpr int kF32PerLane = 2;  // features a lane of the f32 kernel sums: 64 a CTA

__device__ __forceinline__ void load_feats(const float* p, float (&f)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x;
  f[1] = v.y;
}
__device__ __forceinline__ void store_feats(float* p, const float (&a)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bytes of one f32 CTA's shared memory (the wrapper's _dedup_smem mirrors it): two data stages
// (the block's [ub, 64] X row slices, its ordered codes and values), three index stages (its
// meta row, ucols and ordered flat slots) and the run weights W of the block being summed.
__host__ __device__ constexpr size_t dedup_smem_bytes(int eb, int ub) {
  return 2 * (static_cast<size_t>(ub) * kWarp * kF32PerLane * 4 + static_cast<size_t>(eb) * 8) +
         3 * static_cast<size_t>(kMetaPad + ub + eb) * 4 + static_cast<size_t>(eb) * 4;
}

// the rows of split windows: out = the sum of their parts' tiles, in part order
__global__ void __launch_bounds__(kThreads) segment_spmm_dedup_sum_parts_kernel(
    const float4* __restrict__ scratch, const int* __restrict__ window_parts,
    float4* __restrict__ out, int nrows, int rb, int d4) {
  const int64_t n4 = static_cast<int64_t>(nrows) * d4;
  const int64_t tile4 = static_cast<int64_t>(rb) * d4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n4; i += stride) {
    const int r = static_cast<int>(i / d4);
    const int w = r / rb;
    const int p0 = window_parts[w];
    const int p1 = window_parts[w + 1];
    if (p1 - p0 < 2) continue;  // written by the window's only part
    const int64_t off = i - static_cast<int64_t>(w) * tile4;
    float4 s = scratch[p0 * tile4 + off];
    for (int p = p0 + 1; p < p1; ++p) {
      const float4 v = scratch[p * tile4 + off];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// order_rc[b, i] = (local row << 16) | local column of block b's i-th live slot in the order
// (row % 16, row, slot), order_slot[b, i] its flat slot (for the runtime values); block_meta[b]
// = the offsets of the groups k = (row % 16) * 16 + row / 16 in that order, then n_unique.
// Part p takes the blocks [part_blocks[p], part_blocks[p + 1]) of window part_window[p]; window
// w's parts are [window_parts[w], window_parts[w + 1]).
__global__ void __launch_bounds__(kDedupThreads, 1) segment_spmm_dedup_kernel(
    const int* __restrict__ part_window, const int* __restrict__ part_blocks,
    const int* __restrict__ window_parts, const int* __restrict__ ucols,
    const int* __restrict__ order_rc, const int* __restrict__ order_slot,
    const int* __restrict__ block_meta, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ out, float* __restrict__ scratch, int nrows,
    int eb, int rb, int ub, int d) {
  using T = float;
  constexpr int kF = kF32PerLane;
  constexpr int kS = kWarp * kF;  // features per CTA
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t xs_b = static_cast<size_t>(ub) * kS * sizeof(T);
  const size_t data_b = xs_b + static_cast<size_t>(eb) * 8;
  const size_t idx_b = static_cast<size_t>(kMetaPad + ub + eb) * 4;
  unsigned char* const idx0 = smem + 2 * data_b;
  float* const s_w = reinterpret_cast<float*>(idx0 + 3 * idx_b);
  auto xs_of = [&](int k) { return reinterpret_cast<T*>(smem + k * data_b); };
  auto rc_of = [&](int k) { return reinterpret_cast<int*>(smem + k * data_b + xs_b); };
  auto v_of = [&](int k) { return reinterpret_cast<float*>(rc_of(k) + eb); };
  auto idx_of = [&](int k) { return reinterpret_cast<int*>(idx0 + k * idx_b); };

  const int part = blockIdx.x;
  const int win = part_window[part];
  const int c0 = blockIdx.y * kS;
  const int width = min(kS, d - c0);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b0 = part_blocks[part];
  const int b1 = part_blocks[part + 1];

  // block b's meta row, ucols and ordered slots into index stage k
  auto stage_idx = [&](int b, int k) {
    int* dst = idx_of(k);
    for (int i = threadIdx.x; i < kMetaWidth; i += kDedupThreads) {
      cp_async4(dst + i, block_meta + static_cast<int64_t>(b) * kMetaWidth + i);
    }
    for (int i = threadIdx.x; i < ub; i += kDedupThreads) {
      cp_async4(dst + kMetaPad + i, ucols + static_cast<int64_t>(b) * ub + i);
    }
    for (int i = threadIdx.x; i < eb; i += kDedupThreads) {
      cp_async4(dst + kMetaPad + ub + i, order_slot + static_cast<int64_t>(b) * eb + i);
    }
  };
  // block b's X row slices, codes and values into data stage k, from its landed index stage ki
  auto stage_data = [&](int b, int k, int ki) {
    const int* id = idx_of(ki);
    const int n = id[kGroups];
    const int nu = id[kGroups + 1];
    const int vecs = width * static_cast<int>(sizeof(T)) / 16;
    unsigned char* xs = reinterpret_cast<unsigned char*>(xs_of(k));
#pragma unroll 4
    for (int i = threadIdx.x; i < nu * vecs; i += kDedupThreads) {
      const int u = i / vecs;
      const int v = i - u * vecs;
      const T* src = x + static_cast<int64_t>(id[kMetaPad + u]) * d + c0;
      cp_async16(xs + static_cast<size_t>(u) * kS * sizeof(T) + 16 * v,
                 reinterpret_cast<const unsigned char*>(src) + 16 * v);
    }
    int* rc = rc_of(k);
    float* vs = v_of(k);
    for (int i = threadIdx.x; i < n; i += kDedupThreads) {
      cp_async4(rc + i, order_rc + static_cast<int64_t>(b) * eb + i);
      cp_async4(vs + i, vals + id[kMetaPad + ub + i]);
    }
  };

  float acc[kRowsPerWarp][kF] = {};  // the sums of the warp's rows s * 16 + warp
  if (b0 < b1) {
    stage_idx(b0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    stage_data(b0, 0, 0);
    if (b0 + 1 < b1) stage_idx(b0 + 1, 1);
    cp_async_commit();
  }
  for (int b = b0; b < b1; ++b) {
    const int k = (b - b0) & 1;
    const int ki = (b - b0) % 3;
    cp_async_wait_all();
    __syncthreads();  // block b's data and block b + 1's indices landed; block b - 1 is done
    if (b + 1 < b1) {
      stage_data(b + 1, k ^ 1, (ki + 1) % 3);
      if (b + 2 < b1) stage_idx(b + 2, (ki + 2) % 3);
      cp_async_commit();
    }
    const int* id = idx_of(ki);
    const int* rcs = rc_of(k);
    const float* vs = v_of(k);
    // W[r, u] at the last slot of each (row, column) run: the run's bf16-rounded values summed
    // in slot order, then rounded; 0 at the run's other slots
    const int n = id[kGroups];
    for (int i = threadIdx.x; i < n; i += kDedupThreads) {
      const int code = rcs[i];
      float w = 0.f;
      if (i + 1 == n || rcs[i + 1] != code) {
        int j = i;
        while (j > 0 && rcs[j - 1] == code) --j;
        float sum = 0.f;
        for (; j <= i; ++j) sum += vs[j];
        w = sum;
      }
      s_w[i] = w;
    }
    __syncthreads();
    // the warp's 16 row groups: offsets and 32 edges at a time held in lanes and broadcast by
    // shuffles; per edge one shared load of the staged row and kF multiply-adds
    const int my_off = id[warp * kRowsPerWarp + min(lane, kRowsPerWarp)];
    const int first = __shfl_sync(kFull, my_off, 0);
    const int last = __shfl_sync(kFull, my_off, kRowsPerWarp);
    const T* xk = xs_of(k) + kF * lane;
    for (int t0 = first; t0 < last; t0 += kWarp) {
      const bool live = t0 + lane < last;
      const int my_u = live ? (rcs[t0 + lane] & 0xffff) * kS : 0;
      const float my_w = live ? s_w[t0 + lane] : 0.f;
#pragma unroll
      for (int s = 0; s < kRowsPerWarp; ++s) {
        const int j0 = max(__shfl_sync(kFull, my_off, s) - t0, 0);
        const int j1 = min(__shfl_sync(kFull, my_off, s + 1) - t0, kWarp);
        for (int j = j0; j < j1; ++j) {
          const int u = __shfl_sync(kFull, my_u, j);
          const float w = __shfl_sync(kFull, my_w, j);
          float xv[kF];
          load_feats(xk + u, xv);
          if (w != 0.f) {
#pragma unroll
            for (int f = 0; f < kF; ++f) acc[s][f] = fmaf(w, xv[f], acc[s][f]);
          }
        }
      }
    }
  }

  // the part's rows: into the output where the window is one part, else into its scratch tile
  const int rows = min(rb, nrows - win * rb);
  float* dst = window_parts[win + 1] - window_parts[win] == 1
                   ? out + static_cast<int64_t>(win) * rb * d
                   : scratch + static_cast<int64_t>(part) * rb * d;
  if (kF * lane < width) {
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = s * kDedupWarps + warp;
      if (r < rows) store_feats(dst + static_cast<int64_t>(r) * d + c0 + kF * lane, acc[s]);
    }
  }
}

// ---- the bf16 dedup kernel on the tensor cores: per block W[rb, 16-column chunk] x X ----
constexpr int kMmaSlice = 128;             // features per CTA
constexpr int kXsStride = kMmaSlice + 8;   // staged row stride (bf16): 272 B, no bank conflicts
constexpr int kWide = 64;                  // distinct columns a W tile holds (4 mma k-steps)
constexpr int kWStride = kWide + 8;        // W tile row stride (bf16): 144 B, no bank conflicts
constexpr int kChunk = 16;                 // the mma's k
constexpr int kIdxInts = 4;                // staged meta ints before a block's ucols

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p, bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
  }
}

// c += a (16 x 16 bf16, row) x b (16 x 8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes of the bf16 kernel's shared memory (the wrapper's _dedup_smem mirrors it): two data
// stages (the block's [ub, 136] bf16 row slices; its ordered codes and values), three index
// stages (its meta row, ucols and ordered flat slots) and the warps' [16, 64] bf16 W tiles
__host__ __device__ constexpr size_t mma_smem_bytes(int eb, int ub) {
  return 2 * (static_cast<size_t>(ub) * kXsStride * 2 + static_cast<size_t>(eb) * 8) +
         3 * static_cast<size_t>(kMetaPad + ub + eb) * 4 +
         static_cast<size_t>(kGroups) * kWStride * 2;
}

// The bf16 dedup kernel: grid (n_parts, ceil(d / 128)). It stages blocks as the f32 kernel does
// (the block's slots in the order (row % 16, row, slot), so warp w's slots, those of the rows
// r % 16 == w, are consecutive). Warp w keeps the [16, 128] f32 sums of its rows 16 i + w as mma
// accumulators. Per block and 64 distinct columns, the warp writes its rows' W[r, u] (each
// (row, column) run's values rounded, summed and rounded, at the run's last slot) into its own
// [16, 64] bf16 W tile in shared memory (tile row i = window row 16 i + w), then per 16 columns
// runs 16 mma.sync of the tile against the staged X rows: one CTA-wide barrier a block. Needs
// eb and ub multiples of 4 (16-byte copies) and ub <= 256.
__global__ void __launch_bounds__(kDedupThreads, 1) segment_spmm_dedup_mma_kernel(
    const int* __restrict__ part_window, const int* __restrict__ part_blocks,
    const int* __restrict__ window_parts, const int* __restrict__ ucols,
    const int* __restrict__ order_rc, const int* __restrict__ order_slot,
    const int* __restrict__ block_meta, const float* __restrict__ vals,
    const __nv_bfloat16* __restrict__ x, float* __restrict__ out, float* __restrict__ scratch,
    int nrows, int eb, int rb, int ub, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t xs_b = static_cast<size_t>(ub) * kXsStride * 2;
  const size_t data_b = xs_b + static_cast<size_t>(eb) * 8;
  const size_t idx_b = static_cast<size_t>(kMetaPad + ub + eb) * 4;
  unsigned char* const idx0 = smem + 2 * data_b;
  __nv_bfloat16* const wt = reinterpret_cast<__nv_bfloat16*>(idx0 + 3 * idx_b);
  auto xs_of = [&](int k) { return reinterpret_cast<__nv_bfloat16*>(smem + k * data_b); };
  auto rc_of = [&](int k) { return reinterpret_cast<int*>(smem + k * data_b + xs_b); };
  auto v_of = [&](int k) { return reinterpret_cast<float*>(rc_of(k) + eb); };
  auto idx_of = [&](int k) { return reinterpret_cast<int*>(idx0 + k * idx_b); };

  const int part = blockIdx.x;
  const int win = part_window[part];
  const int c0 = blockIdx.y * kMmaSlice;
  const int width = min(kMmaSlice, d - c0);
  const int n_tiles = (width + 7) / 8;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b0 = part_blocks[part];
  const int b1 = part_blocks[part + 1];

  // block b's meta row, ucols and ordered slots into index stage k
  auto stage_idx = [&](int b, int k) {
    int* dst = idx_of(k);
    const int* meta = block_meta + static_cast<int64_t>(b) * kMetaWidth;  // 8-byte aligned
    for (int i = threadIdx.x; i < kMetaWidth / 2; i += kDedupThreads) {
      cp_async8(dst + 2 * i, meta + 2 * i);
    }
    for (int i = threadIdx.x; i < ub / 4; i += kDedupThreads) {
      cp_async16(dst + kMetaPad + 4 * i, ucols + static_cast<int64_t>(b) * ub + 4 * i);
    }
    for (int i = threadIdx.x; i < eb / 4; i += kDedupThreads) {
      cp_async16(dst + kMetaPad + ub + 4 * i, order_slot + static_cast<int64_t>(b) * eb + 4 * i);
    }
  };
  // block b's X rows (zeros up to a whole k-step), codes and values into data stage k, from its
  // landed index stage ki
  auto stage_data = [&](int b, int k, int ki) {
    const int* id = idx_of(ki);
    const int n = id[kGroups];
    const int nu = id[kGroups + 1];
    const int vecs = width * 2 / 16;
    unsigned char* xs = reinterpret_cast<unsigned char*>(xs_of(k));
#pragma unroll 4
    for (int i = threadIdx.x; i < nu * vecs; i += kDedupThreads) {
      const int u = i / vecs;
      const int v = i - u * vecs;
      const __nv_bfloat16* src = x + static_cast<int64_t>(id[kMetaPad + u]) * d + c0;
      cp_async16(xs + static_cast<size_t>(u) * kXsStride * 2 + 16 * v,
                 reinterpret_cast<const unsigned char*>(src) + 16 * v);
    }
    const int nu16 = (nu + kChunk - 1) / kChunk * kChunk;
    for (int i = threadIdx.x; i < (nu16 - nu) * (kXsStride / 8); i += kDedupThreads) {
      reinterpret_cast<uint4*>(xs + static_cast<size_t>(nu) * kXsStride * 2)[i] =
          make_uint4(0, 0, 0, 0);
    }
    for (int i = threadIdx.x; i < (n + 3) / 4; i += kDedupThreads) {
      cp_async16(rc_of(k) + 4 * i, order_rc + static_cast<int64_t>(b) * eb + 4 * i);
    }
    float* vs = v_of(k);
    for (int i = threadIdx.x; i < n; i += kDedupThreads) {
      cp_async4(vs + i, vals + id[kMetaPad + ub + i]);
    }
  };

  float acc[kMmaSlice / 8][4] = {};  // n-tile t: rows 16 (lane / 4) + w (and + 128), ...
  __nv_bfloat16* mw = wt + warp * 16 * kWStride;  // this warp's [16, 64] W tile
  if (b0 < b1) {
    stage_idx(b0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    stage_data(b0, 0, 0);
    if (b0 + 1 < b1) stage_idx(b0 + 1, 1);
    cp_async_commit();
  }
  for (int b = b0; b < b1; ++b) {
    const int k = (b - b0) & 1;
    const int ki = (b - b0) % 3;
    cp_async_wait_all();
    __syncthreads();  // block b's data and block b + 1's indices landed; block b - 1 is done
    if (b + 1 < b1) {
      stage_data(b + 1, k ^ 1, (ki + 1) % 3);
      if (b + 2 < b1) stage_idx(b + 2, (ki + 2) % 3);
      cp_async_commit();
    }
    const int* id = idx_of(ki);
    const int nu = id[kGroups + 1];
    const int o0 = id[warp * kRowsPerWarp];
    const int o1 = id[(warp + 1) * kRowsPerWarp];
    const int* rcs = rc_of(k);
    const float* vs = v_of(k);
    const __nv_bfloat16* xs = xs_of(k);
    for (int kw = 0; kw * kWide < nu; ++kw) {
      for (int i = lane; i < 16 * (kWide / 8); i += kWarp) {
        reinterpret_cast<uint4*>(mw + (i / (kWide / 8)) * kWStride)[i % (kWide / 8)] =
            make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
      // the warp's runs with a column in [64 kw, 64 kw + 64): W at (row / 16, column - 64 kw)
      for (int i = o0 + lane; i < o1; i += kWarp) {
        const int code = rcs[i];
        const int c = (code & 0xffff) - kw * kWide;
        if (c >= 0 && c < kWide && (i + 1 == o1 || rcs[i + 1] != code)) {
          int j = i;
          while (j > o0 && rcs[j - 1] == code) --j;
          float sum = 0.f;
          for (; j <= i; ++j) sum += bf16_round(vs[j]);
          mw[((code >> 16) / kDedupWarps) * kWStride + c] = __float2bfloat16(sum);
        }
      }
      __syncwarp();
      const int steps = min(kWide, nu - kw * kWide + kChunk - 1) / kChunk;
      for (int ks = 0; ks < steps; ++ks) {
        unsigned a[4];
        ldsm_x4(a, mw + (lane & 15) * kWStride + ks * kChunk + (lane >> 4) * 8, false);
        const __nv_bfloat16* xrow =
            xs + (kw * kWide + ks * kChunk + (lane & 15)) * kXsStride + (lane >> 4) * 8;
#pragma unroll
        for (int t = 0; t < kMmaSlice / 8; t += 2) {
          if (t < n_tiles) {
            unsigned bq[4];
            ldsm_x4(bq, xrow + t * 8, true);
            mma_bf16(acc[t], a, bq[0], bq[1]);
            mma_bf16(acc[t + 1], a, bq[2], bq[3]);
          }
        }
      }
      __syncwarp();  // the tile is read before the next one is written
    }
  }

  // the part's rows: into the output where the window is one part, else into its scratch tile
  const int rows = min(rb, nrows - win * rb);
  float* dst = window_parts[win + 1] - window_parts[win] == 1
                   ? out + static_cast<int64_t>(win) * rb * d
                   : scratch + static_cast<int64_t>(part) * rb * d;
  const int r_lo = (lane / 4) * kDedupWarps + warp;  // this lane's rows r_lo, r_lo + 128
  const int f_lo = (lane % 4) * 2;                   // and features 8 t + f_lo, + 1
#pragma unroll
  for (int t = 0; t < kMmaSlice / 8; ++t) {
    if (8 * t + f_lo < width) {
      if (r_lo < rows) {
        *reinterpret_cast<float2*>(dst + static_cast<int64_t>(r_lo) * d + c0 + 8 * t + f_lo) =
            make_float2(acc[t][0], acc[t][1]);
      }
      if (r_lo + 8 * kDedupWarps < rows) {
        *reinterpret_cast<float2*>(dst + static_cast<int64_t>(r_lo + 8 * kDedupWarps) * d + c0 +
                                   8 * t + f_lo) = make_float2(acc[t][2], acc[t][3]);
      }
    }
  }
}

// ---- int8: the quantisation of X per column, then the int8 dedup kernel ----
constexpr int kQuantRowLanes = kThreads / kWarp;  // a quantisation CTA: 32 column vectors x 8 rows

__device__ __forceinline__ float4 abs_max(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, fabsf(b.x)), fmaxf(a.y, fabsf(b.y)), fmaxf(a.z, fabsf(b.z)),
                     fmaxf(a.w, fabsf(b.w)));
}

// launch 1: partial[g, v] = max |x[r, v]| (4 columns a vector v) over the rows r of chunk g,
// [g * rows_per, (g + 1) * rows_per); grid (n_chunks, ceil(d4 / 32))
__global__ void __launch_bounds__(kThreads) column_amax_kernel(
    const float4* __restrict__ x, float4* __restrict__ partial, int m, int d4, int rows_per) {
  __shared__ float4 red[kQuantRowLanes][kWarp];
  const int tx = threadIdx.x % kWarp;
  const int ty = threadIdx.x / kWarp;
  const int v = blockIdx.y * kWarp + tx;
  const int r0 = blockIdx.x * rows_per;
  const int r1 = min(m, r0 + rows_per);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (v < d4) {
    for (int r = r0 + ty; r < r1; r += kQuantRowLanes) {
      a = abs_max(a, __ldg(x + static_cast<int64_t>(r) * d4 + v));
    }
  }
  red[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && v < d4) {
#pragma unroll
    for (int k = 1; k < kQuantRowLanes; ++k) a = abs_max(a, red[k][tx]);
    partial[static_cast<int64_t>(blockIdx.x) * d4 + v] = a;
  }
}

// x / s rounded half to even and clamped, as torch.round and torch.clamp; IEEE division
__device__ __forceinline__ int quantise(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

__device__ __forceinline__ float col_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);  // IEEE f32 division, not a reciprocal
}

// launch 2: each CTA takes the column maxima from the n_chunks partial rows, s = max(amax / 127,
// 1e-12), and quantises the rows of its chunk, [g * rows_per, (g + 1) * rows_per), to
// q = clamp(rint(x / s), -127, 127); CTA 0 writes s. Grid (n_q, ceil(d4 / 32)).
__global__ void __launch_bounds__(kThreads) quantise_kernel(
    const float4* __restrict__ x, const float4* __restrict__ partial, char4* __restrict__ q,
    float4* __restrict__ scale, int m, int d4, int n_chunks, int rows_per) {
  __shared__ float4 red[kQuantRowLanes][kWarp];
  const int tx = threadIdx.x % kWarp;
  const int ty = threadIdx.x / kWarp;
  const int v = blockIdx.y * kWarp + tx;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (v < d4) {
    for (int g = ty; g < n_chunks; g += kQuantRowLanes) {
      a = abs_max(a, __ldg(partial + static_cast<int64_t>(g) * d4 + v));
    }
  }
  red[ty][tx] = a;
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int k = 1; k < kQuantRowLanes; ++k) a = abs_max(a, red[k][tx]);
    const float4 s = make_float4(col_scale(a.x), col_scale(a.y), col_scale(a.z), col_scale(a.w));
    red[0][tx] = s;
    if (blockIdx.x == 0 && v < d4) scale[v] = s;
  }
  __syncthreads();
  const float4 s = red[0][tx];
  const int r0 = blockIdx.x * rows_per;
  const int r1 = min(m, r0 + rows_per);
  if (v >= d4) return;
  for (int r = r0 + ty; r < r1; r += kQuantRowLanes) {
    const int64_t i = static_cast<int64_t>(r) * d4 + v;
    const float4 t = __ldg(x + i);
    q[i] = make_char4(quantise(t.x, s.x), quantise(t.y, s.y), quantise(t.z, s.z),
                      quantise(t.w, s.w));
  }
}

// The int8 dedup kernel (see the header): grid (n_parts, ceil(d / 64)), the dedup kernel's parts,
// work lists and cp.async pipeline; warp w sums its window rows s * 16 + w, 2 features a lane,
// in f64 registers.
constexpr int kInt8PerLane = 2;
constexpr int kInt8Slice = kWarp * kInt8PerLane;  // features a CTA sums: 64 int8 = 64 B a row
// blocks staged ahead of the one being summed (a deeper pipeline was no faster on the H100: the
// walk, not the staging, sets the time)
constexpr int kInt8Ahead = 1;

// bytes of its shared memory (the wrapper's _dedup_smem mirrors it): kInt8Ahead + 1 data stages
// (the block's [ub, 64] int8 row slices, its ordered codes and values; 16-byte aligned),
// 2 kInt8Ahead + 1 index stages (its meta row, ucols and ordered flat slots), the run weights W
// of the block being summed (f64) and its [ub, 64] rows widened to f64
__host__ __device__ constexpr size_t dedup_int8_data_bytes(int eb, int ub) {
  return (static_cast<size_t>(ub) * kInt8Slice + static_cast<size_t>(eb) * 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t dedup_int8_smem_bytes(int eb, int ub) {
  return (kInt8Ahead + 1) * dedup_int8_data_bytes(eb, ub) +
         (2 * kInt8Ahead + 1) * static_cast<size_t>(kMetaPad + ub + eb) * 4 +
         static_cast<size_t>(eb) * 8 + static_cast<size_t>(ub) * kInt8Slice * 8;
}

__global__ void __launch_bounds__(kDedupThreads, 1) segment_spmm_dedup_int8_kernel(
    const int* __restrict__ part_window, const int* __restrict__ part_blocks,
    const int* __restrict__ window_parts, const int* __restrict__ ucols,
    const int* __restrict__ order_rc, const int* __restrict__ order_slot,
    const int* __restrict__ block_meta, const float* __restrict__ vals,
    const int8_t* __restrict__ xq, const float* __restrict__ scale, float* __restrict__ out,
    double* __restrict__ scratch, int nrows, int eb, int rb, int ub, int d) {
  constexpr int kDataStages = kInt8Ahead + 1;
  constexpr int kIdxStages = 2 * kInt8Ahead + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t xs_b = static_cast<size_t>(ub) * kInt8Slice;
  const size_t data_b = dedup_int8_data_bytes(eb, ub);
  const size_t idx_b = static_cast<size_t>(kMetaPad + ub + eb) * 4;
  double* const xd = reinterpret_cast<double*>(smem);  // the block's rows as f64, [ub, 64]
  unsigned char* const data0 = smem + static_cast<size_t>(ub) * kInt8Slice * 8;
  double* const s_w = reinterpret_cast<double*>(data0 + kDataStages * data_b);
  unsigned char* const idx0 = reinterpret_cast<unsigned char*>(s_w + eb);
  auto xs_of = [&](int k) { return reinterpret_cast<int8_t*>(data0 + k * data_b); };
  auto rc_of = [&](int k) { return reinterpret_cast<int*>(data0 + k * data_b + xs_b); };
  auto v_of = [&](int k) { return reinterpret_cast<float*>(rc_of(k) + eb); };
  auto idx_of = [&](int k) { return reinterpret_cast<int*>(idx0 + k * idx_b); };

  const int part = blockIdx.x;
  const int win = part_window[part];
  const int c0 = blockIdx.y * kInt8Slice;
  const int width = min(kInt8Slice, d - c0);  // 32 or 64 (d % 32 == 0)
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b0 = part_blocks[part];
  const int b1 = part_blocks[part + 1];

  // block b's meta row, ucols and ordered slots into its index stage
  auto stage_idx = [&](int b) {
    if (b >= b1) return;
    int* dst = idx_of((b - b0) % kIdxStages);
    for (int i = threadIdx.x; i < kMetaWidth; i += kDedupThreads) {
      cp_async4(dst + i, block_meta + static_cast<int64_t>(b) * kMetaWidth + i);
    }
    for (int i = threadIdx.x; i < ub; i += kDedupThreads) {
      cp_async4(dst + kMetaPad + i, ucols + static_cast<int64_t>(b) * ub + i);
    }
    for (int i = threadIdx.x; i < eb; i += kDedupThreads) {
      cp_async4(dst + kMetaPad + ub + i, order_slot + static_cast<int64_t>(b) * eb + i);
    }
  };
  // block b's int8 row slices, codes and values into its data stage, from its landed index stage
  auto stage_data = [&](int b) {
    if (b >= b1) return;
    const int* id = idx_of((b - b0) % kIdxStages);
    const int k = (b - b0) % kDataStages;
    const int n = id[kGroups];
    const int nu = id[kGroups + 1];
    const int vecs = width / 16;
    int8_t* xs = xs_of(k);
    for (int i = threadIdx.x; i < nu * vecs; i += kDedupThreads) {
      const int u = i / vecs;
      const int v = i - u * vecs;
      cp_async16(xs + u * kInt8Slice + 16 * v,
                 xq + static_cast<int64_t>(id[kMetaPad + u]) * d + c0 + 16 * v);
    }
    int* rc = rc_of(k);
    float* vs = v_of(k);
    for (int i = threadIdx.x; i < n; i += kDedupThreads) {
      cp_async4(rc + i, order_rc + static_cast<int64_t>(b) * eb + i);
      cp_async4(vs + i, vals + id[kMetaPad + ub + i]);
    }
  };

  // the pipeline: the first 2 kInt8Ahead blocks' indices, then one group per block ahead; block
  // b's turn issues block b + kInt8Ahead's data and block b + 2 kInt8Ahead's indices, so the
  // groups of the blocks up to b landed once all but the last kInt8Ahead - 1 groups have
  for (int j = 0; j < 2 * kInt8Ahead; ++j) stage_idx(b0 + j);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int j = 0; j < kInt8Ahead; ++j) {
    stage_data(b0 + j);
    cp_async_commit();
  }
  double acc[kRowsPerWarp][kInt8PerLane] = {};  // the sums of the warp's rows s * 16 + warp
  for (int b = b0; b < b1; ++b) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kInt8Ahead - 1) : "memory");
    __syncthreads();  // block b's data and block b + kInt8Ahead's indices landed; b - 1 is done
    stage_data(b + kInt8Ahead);
    stage_idx(b + 2 * kInt8Ahead);
    cp_async_commit();
    const int k = (b - b0) % kDataStages;
    const int* id = idx_of((b - b0) % kIdxStages);
    const int* rcs = rc_of(k);
    const float* vs = v_of(k);
    // W[r, u] at the last slot of each (row, column) run: the run's bf16-rounded values summed
    // in f32 in slot order, then rounded to bf16; 0 at the run's other slots
    const int n = id[kGroups];
    for (int i = threadIdx.x; i < n; i += kDedupThreads) {
      const int code = rcs[i];
      float w = 0.f;
      if (i + 1 == n || rcs[i + 1] != code) {
        int j = i;
        while (j > 0 && rcs[j - 1] == code) --j;
        float sum = 0.f;
        for (; j <= i; ++j) sum += bf16_round(vs[j]);
        w = bf16_round(sum);
      }
      s_w[i] = w;
    }
    // the block's staged rows, each int8 widened to f64 once here rather than at every run: the
    // per-run conversions were a large share of the walk
    const int8_t* xs = xs_of(k);
    const int nu = id[kGroups + 1];
    for (int i = threadIdx.x; i < nu * kInt8Slice; i += kDedupThreads) xd[i] = xs[i];
    __syncthreads();
    // the warp's 16 row groups: offsets and 32 edges at a time held in lanes and broadcast by
    // shuffles; per run one shared load of the staged row and two f64 multiply-adds, exact
    const int my_off = id[warp * kRowsPerWarp + min(lane, kRowsPerWarp)];
    const int first = __shfl_sync(kFull, my_off, 0);
    const int last = __shfl_sync(kFull, my_off, kRowsPerWarp);
    for (int t0 = first; t0 < last; t0 += kWarp) {
      const bool live = t0 + lane < last;
      const int my_u = live ? (rcs[t0 + lane] & 0xffff) * kInt8Slice : 0;
      const double my_w = live ? s_w[t0 + lane] : 0.0;
#pragma unroll
      for (int s = 0; s < kRowsPerWarp; ++s) {
        const int j0 = max(__shfl_sync(kFull, my_off, s) - t0, 0);
        const int j1 = min(__shfl_sync(kFull, my_off, s + 1) - t0, kWarp);
        for (int j = j0; j < j1; ++j) {
          const int u = __shfl_sync(kFull, my_u, j);
          const double w = __shfl_sync(kFull, my_w, j);
          const double2 q = *reinterpret_cast<const double2*>(xd + u + kInt8PerLane * lane);
          if (w != 0.0) {
            acc[s][0] = fma(w, q.x, acc[s][0]);
            acc[s][1] = fma(w, q.y, acc[s][1]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA

  // the part's rows: dequantised into the output where the window is one part, else as f64 into
  // its scratch tile
  if (kInt8PerLane * lane >= width) return;
  const int rows = min(rb, nrows - win * rb);
  const int c = c0 + kInt8PerLane * lane;
  if (window_parts[win + 1] - window_parts[win] == 1) {
    const float s0 = scale[c];
    const float s1 = scale[c + 1];
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = s * kDedupWarps + warp;
      if (r < rows) {
        *reinterpret_cast<float2*>(out + (static_cast<int64_t>(win) * rb + r) * d + c) =
            make_float2(__double2float_rn(acc[s][0]) * s0, __double2float_rn(acc[s][1]) * s1);
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = s * kDedupWarps + warp;
      if (r < rows) {
        *reinterpret_cast<double2*>(scratch + (static_cast<int64_t>(part) * rb + r) * d + c) =
            make_double2(acc[s][0], acc[s][1]);
      }
    }
  }
}

// the rows of split windows: out = the f64 sum of their parts' tiles in part order, rounded to f32
// and scaled, as the windows of one part are
__global__ void __launch_bounds__(kThreads) segment_spmm_dedup_int8_sum_parts_kernel(
    const double2* __restrict__ scratch, const int* __restrict__ window_parts,
    const float2* __restrict__ scale, float2* __restrict__ out, int nrows, int rb, int d2) {
  const int64_t n2 = static_cast<int64_t>(nrows) * d2;
  const int64_t tile2 = static_cast<int64_t>(rb) * d2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n2; i += stride) {
    const int r = static_cast<int>(i / d2);
    const int w = r / rb;
    const int p0 = window_parts[w];
    const int p1 = window_parts[w + 1];
    if (p1 - p0 < 2) continue;  // written by the window's only part
    const int64_t off = i - static_cast<int64_t>(w) * tile2;
    double2 s = scratch[p0 * tile2 + off];
    for (int p = p0 + 1; p < p1; ++p) {
      const double2 v = scratch[p * tile2 + off];
      s.x += v.x;
      s.y += v.y;
    }
    const float2 sc = scale[i % d2];
    out[i] = make_float2(__double2float_rn(s.x) * sc.x, __double2float_rn(s.y) * sc.y);
  }
}

template <typename T>
int launch_rows(const int* warp_rows, const int* row_start, const int* row_end, const int* cols,
                const float* vals, const void* x, typename Vec<T>::Acc* out, int n_ctas, int d,
                int lanes_log2, int row_slots, cudaStream_t stream) {
  if (n_ctas <= 0) return 0;
  segment_spmm_rows_kernel<T><<<n_ctas, kThreads, 0, stream>>>(
      warp_rows, row_start, row_end, cols, vals, static_cast<const T*>(x), out, d, lanes_log2,
      row_slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dedup(const int* part_window, const int* part_blocks, const int* window_parts,
                 const int* ucols, const int* order_rc, const int* order_slot,
                 const int* block_meta, const float* vals, const void* x,
                 float* out, float* scratch, int n_parts, int n_windows, int nrows, int eb,
                 int rb, int ub, int d, cudaStream_t stream) {
  if (n_parts <= 0 || nrows <= 0) return 0;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kS = kMma ? kMmaSlice : kWarp * kF32PerLane;
  const dim3 grid(n_parts, (d + kS - 1) / kS);
  cudaError_t err;
  if constexpr (kMma) {
    const int smem = static_cast<int>(mma_smem_bytes(eb, ub));
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(segment_spmm_dedup_mma_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_spmm_dedup_mma_kernel<<<grid, kDedupThreads, smem, stream>>>(
        part_window, part_blocks, window_parts, ucols, order_rc, order_slot, block_meta, vals,
        static_cast<const __nv_bfloat16*>(x), out, scratch, nrows, eb, rb, ub, d);
  } else {
    const int smem = static_cast<int>(dedup_smem_bytes(eb, ub));
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(segment_spmm_dedup_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_spmm_dedup_kernel<<<grid, kDedupThreads, smem, stream>>>(
        part_window, part_blocks, window_parts, ucols, order_rc, order_slot, block_meta, vals,
        static_cast<const float*>(x), out, scratch, nrows, eb, rb, ub, d);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_parts == n_windows) return rc;  // no window was split
  const int64_t n4 = static_cast<int64_t>(nrows) * d / 4;
  const int blocks = static_cast<int>(std::min<int64_t>((n4 + kThreads - 1) / kThreads, 132 * 8));
  segment_spmm_dedup_sum_parts_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(scratch), window_parts, reinterpret_cast<float4*>(out), nrows,
      rb, d / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, allocates nothing, and returns
// the cudaError_t of its launches (0 on success). `x` is [ncols, d], 16-byte aligned: f32 or
// (x_bf16 != 0) bf16 with d % 8 == 0, writing every row of the f32 `out` [nrows, d] (the dedup
// kernel through the f32 `scratch` [n_parts, rb, d] where a window has several parts); or, for
// the _int8 entry points, int8 with d % 32 == 0 beside its per-column f32 `scale` [d], writing
// the dequantised f32 `out` whole: the base kernel straight, the dedup kernel through the f64
// `scratch` [n_parts, rb, d] where a window has several parts (no zeroing needed). `lanes_log2`
// is log2 of the lanes a base-kernel team spreads one X row over (the wrapper's choice: 16 B a
// lane, so 16 int8 features a lane in kernel 3, which takes row_slots <= 512).

extern "C" int hd_segment_spmm_rows(const int* warp_rows, const int* row_start,
                                    const int* row_end, const int* cols, const float* vals,
                                    const void* x, int x_bf16, float* out, int n_ctas, int d,
                                    int lanes_log2, int row_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_rows<__nv_bfloat16>(warp_rows, row_start, row_end, cols, vals, x, out,
                                             n_ctas, d, lanes_log2, row_slots, s)
                : launch_rows<float>(warp_rows, row_start, row_end, cols, vals, x, out, n_ctas,
                                     d, lanes_log2, row_slots, s);
}

extern "C" int hd_segment_spmm_dedup(const int* part_window, const int* part_blocks,
                                     const int* window_parts, const int* ucols,
                                     const int* order_rc, const int* order_slot,
                                     const int* block_meta, const float* vals, const void* x,
                                     int x_bf16, float* out, float* scratch, int n_parts,
                                     int n_windows, int nrows, int eb, int rb, int ub, int d,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_dedup<__nv_bfloat16>(part_window, part_blocks, window_parts, ucols,
                                              order_rc, order_slot, block_meta, vals, x, out,
                                              scratch, n_parts, n_windows, nrows, eb, rb, ub, d, s)
                : launch_dedup<float>(part_window, part_blocks, window_parts, ucols, order_rc,
                                      order_slot, block_meta, vals, x, out, scratch, n_parts,
                                      n_windows, nrows, eb, rb, ub, d, s);
}

extern "C" int hd_segment_spmm_rows_int8(const int* warp_rows, const int* row_start,
                                         const int* row_end, const int* cols, const float* vals,
                                         const void* xq, const float* scale, float* out,
                                         int n_ctas, int d, int lanes_log2, int row_slots,
                                         void* stream) {
  if (row_slots > kSumSlots) return static_cast<int>(cudaErrorInvalidValue);  // one chunk a row
  if (n_ctas <= 0) return 0;
  const int8_t* q = static_cast<const int8_t*>(xq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes_log2) {
    case 1: return launch_rows_int8<1>(warp_rows, row_start, row_end, cols, vals, q, scale, out, n_ctas, d, row_slots, s);
    case 2: return launch_rows_int8<2>(warp_rows, row_start, row_end, cols, vals, q, scale, out, n_ctas, d, row_slots, s);
    case 3: return launch_rows_int8<3>(warp_rows, row_start, row_end, cols, vals, q, scale, out, n_ctas, d, row_slots, s);
    case 4: return launch_rows_int8<4>(warp_rows, row_start, row_end, cols, vals, q, scale, out, n_ctas, d, row_slots, s);
    case 5: return launch_rows_int8<5>(warp_rows, row_start, row_end, cols, vals, q, scale, out, n_ctas, d, row_slots, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int hd_segment_spmm_dedup_int8(const int* part_window, const int* part_blocks,
                                          const int* window_parts, const int* ucols,
                                          const int* order_rc, const int* order_slot,
                                          const int* block_meta, const float* vals,
                                          const void* xq, const float* scale, float* out,
                                          double* scratch, int n_parts, int n_windows, int nrows,
                                          int eb, int rb, int ub, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_parts <= 0 || nrows <= 0) return 0;
  const int smem = static_cast<int>(dedup_int8_smem_bytes(eb, ub));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(segment_spmm_dedup_int8_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_parts, (d + kInt8Slice - 1) / kInt8Slice);
  segment_spmm_dedup_int8_kernel<<<grid, kDedupThreads, smem, s>>>(
      part_window, part_blocks, window_parts, ucols, order_rc, order_slot, block_meta, vals,
      static_cast<const int8_t*>(xq), scale, out, scratch, nrows, eb, rb, ub, d);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_parts == n_windows) return rc;  // no window was split
  const int64_t n2 = static_cast<int64_t>(nrows) * d / 2;
  const int blocks = static_cast<int>(std::min<int64_t>((n2 + kThreads - 1) / kThreads, 132 * 8));
  segment_spmm_dedup_int8_sum_parts_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const double2*>(scratch), window_parts,
      reinterpret_cast<const float2*>(scale), reinterpret_cast<float2*>(out), nrows, rb, d / 2);
  return static_cast<int>(cudaGetLastError());
}

// hd_quantize_int8: q [m, d] int8 and scale [d] f32 from x [m, d] f32 (d % 4 == 0, finite), bit for
// bit as the plain quantize_int8; `partial` [n_chunks, d] f32 is scratch. Two launches: the
// column maxima of n_chunks row chunks, then n_q CTAs that each reduce them and quantise a chunk.
extern "C" int hd_quantize_int8(const float* x, void* q, float* scale, float* partial, int m,
                                int d, int n_chunks, int n_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || n_chunks <= 0 || n_q <= 0) return 0;
  const int d4 = d / 4;
  const int slabs = (d4 + kWarp - 1) / kWarp;
  column_amax_kernel<<<dim3(n_chunks, slabs), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(partial), m, d4,
      (m + n_chunks - 1) / n_chunks);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  quantise_kernel<<<dim3(n_q, slabs), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(partial),
      static_cast<char4*>(q), reinterpret_cast<float4*>(scale), m, d4, n_chunks,
      (m + n_q - 1) / n_q);
  return static_cast<int>(cudaGetLastError());
}
