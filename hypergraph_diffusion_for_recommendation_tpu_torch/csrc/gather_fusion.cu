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
//  * The fused product: the TPU grid walks a window's edge blocks in order and accumulates the
//    window's [rb, d] f32 tile in the output block across grid steps. On Hopper nothing carries
//    over between CTAs, so one CTA takes a whole window: it zeroes the [rb, d] f32 tile in shared
//    memory (128 KB at rb 256, d 128, through the dynamic shared memory opt-in), walks the
//    window's blocks, adds each live slot's val * X[col] into its row of the tile with shared
//    float atomics, and writes the tile once with coalesced float4 stores: no global atomics and
//    no zero fill of the output. An empty window has one all-pad block (pack_blocked), so its
//    tile is written as zeros. A warp reads 32 slots' (row, col, val) in one coalesced load,
//    broadcasts them by shuffles and keeps kSlots X rows in flight before their adds; a lane
//    holds the features lane, lane + 32, ..., so a warp's 32 shared atomics hit 32 banks.
//  * Known limit: a CTA per window gives 77 CTAs at the probe's N = 19712, rb = 256, on 132 SMs;
//    a window's edges (about 3400 at the probe's density) are summed by the 8 warps of one SM.
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
constexpr int kSlots = 4;    // slots whose X rows a warp of the fused kernel has in flight
constexpr int kMaxFeat = 8;  // features per lane in the fused kernel: d <= 256

template <typename T>
struct Elem;

// product: one slot's contribution to one feature, rounded as the TPU kernel rounds it
template <>
struct Elem<float> {
  static __device__ __forceinline__ float product(float v, float x) { return v * x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float product(float v, __nv_bfloat16 x) {
    const float vb = __bfloat162float(__float2bfloat16(v));
    return __bfloat162float(__float2bfloat16(vb * __bfloat162float(x)));
  }
};

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

__device__ __forceinline__ int first_at_least(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One CTA per row window (grid n_windows): the window's [rb, d] f32 tile in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_window_spmm_kernel(
    const int* __restrict__ wmap, const int* __restrict__ cols, const int* __restrict__ lrows,
    const float* __restrict__ vals, const T* __restrict__ x, float* __restrict__ out,
    int n_blocks, int eb, int rb, int d) {
  extern __shared__ __align__(16) float tile[];
  const int win = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_tile = rb * d;
  for (int i = threadIdx.x; i < n_tile; i += kThreads) tile[i] = 0.f;
  // the window's blocks [lo, hi) of the non-decreasing wmap (the trailing pad blocks repeat the
  // last window and hold pad slots only)
  const int64_t s0 = static_cast<int64_t>(first_at_least(wmap, n_blocks, win)) * eb;
  const int64_t s1 = static_cast<int64_t>(first_at_least(wmap, n_blocks, win + 1)) * eb;
  const int per_lane = d / kWarp;
  __syncthreads();

  for (int64_t t0 = s0 + warp * kWarp; t0 < s1; t0 += kThreads) {
    const int64_t t = t0 + lane;
    int my_row = rb;  // rb = a pad slot
    int my_col = 0;
    float my_val = 0.f;
    if (t < s1) {
      my_row = lrows[t];
      if (my_row < rb) {
        my_col = cols[t];
        my_val = vals[t];
      }
    }
    for (int j0 = 0; j0 < kWarp; j0 += kSlots) {
      int row[kSlots];
      float p[kSlots][kMaxFeat];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        row[u] = __shfl_sync(kFull, my_row, j0 + u);
        const int col = __shfl_sync(kFull, my_col, j0 + u);
        const float v = __shfl_sync(kFull, my_val, j0 + u);
        const T* xr = x + static_cast<int64_t>(col) * d + lane;
#pragma unroll
        for (int k = 0; k < kMaxFeat; ++k) {
          p[u][k] = (k < per_lane && row[u] < rb) ? Elem<T>::product(v, xr[k * kWarp]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (row[u] >= rb) continue;  // uniform over the warp: the slot was broadcast
        float* tr = tile + row[u] * d + lane;
#pragma unroll
        for (int k = 0; k < kMaxFeat; ++k) {
          if (k < per_lane) atomicAdd(tr + k * kWarp, p[u][k]);
        }
      }
    }
  }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + static_cast<int64_t>(win) * n_tile);
  const float4* tv = reinterpret_cast<const float4*>(tile);
  for (int i = threadIdx.x; i < n_tile / 4; i += kThreads) o[i] = tv[i];
}

template <typename T>
int launch_fused(const int* wmap, const int* cols, const int* lrows, const float* vals,
                 const void* x, float* out, int n_blocks, int n_windows, int eb, int rb, int d,
                 cudaStream_t stream) {
  if (n_windows <= 0) return 0;
  const int smem = rb * d * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fused_window_spmm_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_window_spmm_kernel<T><<<n_windows, kThreads, smem, stream>>>(
      wmap, cols, lrows, vals, static_cast<const T*>(x), out, n_blocks, eb, rb, d);
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
// ([n_blocks, eb] cols, local_rows, vals; wmap [n_blocks]) and x [ncols, d], f32 or (x_bf16 != 0)
// bf16; d % 32 == 0, d <= 256, rb * d * 4 bytes of shared memory.
extern "C" int hd_fused_window_spmm(const int* wmap, const int* cols, const int* lrows,
                                    const float* vals, const void* x, int x_bf16, float* out,
                                    int n_blocks, int n_windows, int eb, int rb, int d,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_fused<__nv_bfloat16>(wmap, cols, lrows, vals, x, out, n_blocks,
                                              n_windows, eb, rb, d, s)
                : launch_fused<float>(wmap, cols, lrows, vals, x, out, n_blocks, n_windows, eb,
                                      rb, d, s);
}
