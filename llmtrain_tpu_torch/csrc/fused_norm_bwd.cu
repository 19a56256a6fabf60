// Fused LayerNorm backward for Hopper (sm_90a), written by hand, with the
// residual stream's gradient folded in. One launch computes ds (or dx),
// dscale and dbias.
//
// Replaces the TPU kernel of llmtrain_tpu/ops/fused_norm.py:
//   `_run_backward` (:158), kernel `_bwd_kernel` (:80), pallas_call at :168.
//
// Per token row of width d, with the forward's f32 mean and rstd:
//   xhat   = (s - mean) * rstd,   dxhat = gy * scale
//   m1     = sum(dxhat) / d,      m2 = sum(dxhat * xhat) / d
//   ds     = rstd * ((dxhat - m1) - xhat * m2)        rounded to T
//   dx     = T(float(T(ds)) + float(gs))               when gs is given
//   dscale = sum_rows(gy * xhat),  dbias = sum_rows(gy)  (f32)
// gs is the cotangent of the forward's returned sum s = x + residual (the
// residual stream). The two roundings of dx are those of
// `(ds + gs).to(dtype)`, which the JAX package runs after its pallas_call
// (fused_norm.py:252); one rounding of the f32 sum would differ from it in
// about a quarter of the bf16 elements.
//
// Layouts (row-major, contiguous): s, gy, gs, dx (n, d) of T (float or
// bf16); scale (d,), mean and rstd (n,) f32; dscale and dbias one f32
// buffer (2, d). workspace: f32; counters: zeroed unsigned ints that the
// kernel leaves zeroed.
//
// What bounds it: bytes. At (32768, 768) bf16 it reads s and gy and writes
// ds, 151 MB, 0.0452 ms at 3.35 TB/s (with gs, 202 MB, 0.0602 ms); it does
// about 12 flop per element. The TPU kernel walks 256-token blocks in
// order and keeps dscale/dbias in one output block that every grid step
// revisits; on the GPU blocks run in no order, so:
//   * One warp owns a row. Each lane holds its share of the row in
//     registers as 16-byte vectors (at d = 768 bf16, three of s, three of
//     gy), so m1 and m2 are a lane's own sums and a __shfl_xor_sync
//     butterfly: no block barrier per row.
//   * Rows in flight. Each warp streams its rows through its own ring of
//     kStages row-sized stages in shared memory: lane 0 asks for each row
//     of s, gy (and gs) with one bulk copy (the Tensor Memory Accelerator,
//     bulk_copy.cuh), completion counted on the stage's mbarrier, so up to
//     kStages - 1 rows (3 at d = 768) are in flight a warp while it
//     reduces one. The rows' mean and rstd come 32 rows at a time, lane k
//     holding row i + k's, handed out by __shfl_sync.
//   * A fixed split of rows. A block of eight warps (CTA c) owns rows
//     [c * rows_per_cta, (c + 1) * rows_per_cta); warp w takes rows
//     w, w + 8, ... of that run in order. The host picks the grid from n,
//     d and the SM count (ops/fused_norm.py, _bwd_grid), so the order of
//     every sum depends only on those.
//   * dscale/dbias: each lane sums its columns over its warp's rows in f32
//     registers; at the end each warp writes its sums into its own slice
//     of the (then idle) ring, and after one barrier each thread adds its
//     columns over the eight warps in warp order into the CTA's partial
//     (2 x d f32) in the workspace. The CTAs form groups of `group` (about
//     the square root of the grid: 11 groups of 12 at 132 CTAs). Each CTA
//     fences and draws a ticket from its group's counter with one integer
//     atomicAdd; the group's last CTA adds the group's partials in CTA
//     order, then draws a ticket from the last counter, and the last group
//     to finish adds the group sums in group order into dscale and dbias.
//     Each counter is reset by the CTA that drew its last ticket. No float
//     atomics: reruns are bit-identical.
//   * Widths: the register path takes d a multiple of 8 (bf16) or 4 (f32)
//     up to 1024 with 16-byte aligned operands (every GPT preset of the
//     repo); any other d takes the general path, one warp per row with
//     scalar loads over the row twice and each warp's dscale/dbias sums
//     in its own slice of the workspace, summed in the same order.
// What the designs measured (tools/fused_norm_bwd_variants.py, H100 SXM,
// 700 W, (32768, 768) bf16, device time): the first (the next row held in
// registers, the warps' sums added warp by warp with a barrier each, one
// CTA adding all 132 partials) took 0.111 ms, 32 us of it the grid sum;
// the two-level sum brought it to 0.078 ms, and neither a cp.async ring
// nor bulk copies in place of the registers moved that (0.078 ms each);
// the warp-by-warp partial cost 13 us, and one barrier brought the kernel
// to 0.064 ms. Stages 2, 4 or 6 time the same: what is left is the spread
// between SMs (their blocks end 39-56 us after the start for the same
// rows) and the grid sum (5 us).
// No tensor cores: there is no product to run on them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kWarps = 8;               // warps per block, one row each at a time
constexpr int kThreads = kWarps * 32;
constexpr int kMinCtas = 1;             // blocks per SM the registers are sized for
constexpr int kMaxFastD = 1024;         // widest row of the register path
constexpr int kMaxCounters = 64;        // ticket counters: one per group and one more
constexpr int kSmemBudget = 226 * 1024; // dynamic shared memory a block may take
constexpr int kMaxStages = 4;           // rows a warp holds: kMaxStages - 1 in flight

// One stage of a warp's ring, in 16-byte vectors: s, gy and gs of one
// row (J vectors a lane each, the row's bytes from the first).
template <int J>
constexpr int kStageVecs = 3 * J * 32;
// Stages a warp: kMaxStages, or as many as the budget holds (two at the
// widest f32 rows).
template <int J>
constexpr int kStages = kSmemBudget / (kWarps * kStageVecs<J> * 16) < kMaxStages
                            ? kSmemBudget / (kWarps * kStageVecs<J> * 16)
                            : kMaxStages;
template <int J>
constexpr size_t kSmemBytes = (size_t)kWarps * kStages<J> * kStageVecs<J> * 16;

// 16-byte vectors of T: kN elements, to and from f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  __nv_bfloat162 h;
  memcpy(&h, &w, sizeof(w));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t float2_to_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t w;
  memcpy(&w, &h, sizeof(w));
  return w;
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = bf16x2_to_float2(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(float2_to_bf16x2(f[0], f[1]), float2_to_bf16x2(f[2], f[3]),
                      float2_to_bf16x2(f[4], f[5]), float2_to_bf16x2(f[6], f[7]));
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a T tensor holds.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const void* s;
  const void* gy;
  const void* gs;  // null: write ds
  const float* scale;
  const float* mean;
  const float* rstd;
  void* dx;
  float* workspace;
  unsigned int* counter;
  float* sums;
  int n;
  int d;
  int rows_per_cta;
  int group;  // CTAs a group of the two-level sum
};

__device__ __forceinline__ void add_to(float& acc, float x) { acc += x; }
__device__ __forceinline__ void add_to(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// dst[col] = src[0][col] + src[1][col] + ... + src[rows - 1][col], summed
// in row order from 0, by vectors V of floats (float4 when the width
// allows it); the loads of kBatch rows are in flight together.
template <typename V>
__device__ void sum_rows_of(const float* src, int rows, int width, float* dst) {
  constexpr int kCols = 2, kBatch = 12;
  const int cols = width / (int)(sizeof(V) / sizeof(float));
  const V* in = reinterpret_cast<const V*>(src);
  V* out = reinterpret_cast<V*>(dst);
  const int tid = threadIdx.x;
  for (int base = 0; base < cols; base += kThreads * kCols) {
    V acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = V{};
    for (int r0 = 0; r0 < rows; r0 += kBatch) {
      V v[kBatch][kCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int col = base + tid + k * kThreads;
          v[q][k] = r0 + q < rows && col < cols ? __ldcg(in + (size_t)(r0 + q) * cols + col) : V{};
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (r0 + q < rows) add_to(acc[k], v[q][k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = base + tid + k * kThreads;
      if (col < cols) out[col] = acc[k];
    }
  }
}

__device__ void sum_rows(const float* src, int rows, int width, float* dst) {
  if (width % 4 == 0)
    sum_rows_of<float4>(src, rows, width, dst);
  else
    sum_rows_of<float>(src, rows, width, dst);
}

// After every thread of the CTA has written its share of the CTA's
// partial (width f32 at workspace + blockIdx.x * width): the two-level
// sum over the grid into sums, by tickets (see the note at the top).
__device__ void finish(const Args& a, int width) {
  __shared__ bool last;
  const int ctas = gridDim.x, n_groups = (ctas + a.group - 1) / a.group;
  const int g = blockIdx.x / a.group, first = g * a.group, count = min(a.group, ctas - first);
  float* group_sums = a.workspace + (size_t)ctas * width;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counter + g, 1u) == (unsigned)count - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const bool one_group = n_groups == 1;
  sum_rows(a.workspace + (size_t)first * width, count, width,
           one_group ? a.sums : group_sums + (size_t)g * width);
  if (threadIdx.x == 0) a.counter[g] = 0u;
  if (one_group) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counter + n_groups, 1u) == (unsigned)n_groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(group_sums, n_groups, width, a.sums);
  if (threadIdx.x == 0) a.counter[n_groups] = 0u;
}

// The register path: J vectors of Vec<T>::kN columns a lane, column
// (j * 32 + lane) * kN + e for vector j, element e.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads, kMinCtas) fused_norm_bwd_kernel(Args a) {
  constexpr int kN = Vec<T>::kN, kS = kStages<J>, kSV = kStageVecs<J>;
  extern __shared__ uint4 ring[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = a.d, nvec = d / kN;
  const bool with_gs = a.gs != nullptr;

  float scale[J][kN], acc_w[J][kN], acc_b[J][kN];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int v = j * 32 + lane;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      scale[j][e] = v < nvec ? __ldg(a.scale + v * kN + e) : 0.0f;
      acc_w[j][e] = acc_b[j][e] = 0.0f;
    }
  }

  // The warp's rows: first, first + stride, ... below row_end.
  const int cta = blockIdx.x;
  const int row_end = min(a.n, (cta + 1) * a.rows_per_cta);
  const int first = cta * a.rows_per_cta + warp, stride = kWarps;
  const int rows = first < row_end ? (row_end - first + stride - 1) / stride : 0;
  uint4* mine = ring + (size_t)warp * kS * kSV;
  __shared__ uint64_t full[kWarps][kS];  // a stage's bytes have landed
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  if (lane == 0) {
    for (int st = 0; st < kS; ++st) bulk_copy::init(&full[warp][st]);
    bulk_copy::fence_init();
  }
  __syncwarp();
  // Lane 0 asks for the warp's i-th row into stage i % kS.
  auto issue = [&](int i) {
    if (lane != 0 || i >= rows) return;
    const size_t off = (size_t)(first + i * stride) * d;
    uint4* st = mine + (i % kS) * kSV;
    uint64_t* bar = &full[warp][i % kS];
    bulk_copy::fence_reuse();
    bulk_copy::expect(bar, row_bytes * (with_gs ? 3 : 2));
    bulk_copy::load(st, static_cast<const T*>(a.s) + off, row_bytes, bar);
    bulk_copy::load(st + J * 32, static_cast<const T*>(a.gy) + off, row_bytes, bar);
    if (with_gs)
      bulk_copy::load(st + 2 * J * 32, static_cast<const T*>(a.gs) + off, row_bytes, bar);
  };
  for (int i = 0; i < kS - 1; ++i) issue(i);
  // mean and rstd of 32 rows at a time, lane k holding row i + k's; the
  // next 32 loaded one batch ahead.
  auto stats_of = [&](int i0, float& m, float& r) {
    const int i = i0 + lane;
    m = i < rows ? __ldg(a.mean + first + i * stride) : 0.0f;
    r = i < rows ? __ldg(a.rstd + first + i * stride) : 0.0f;
  };
  float mean_b, rstd_b, mean_n, rstd_n;
  stats_of(0, mean_b, rstd_b);
  stats_of(32, mean_n, rstd_n);

  for (int i = 0; i < rows; ++i) {
    issue(i + kS - 1);
    if (i % 32 == 0 && i > 0) {
      mean_b = mean_n;
      rstd_b = rstd_n;
      stats_of(i + 32, mean_n, rstd_n);
    }
    const float mean = __shfl_sync(0xffffffffu, mean_b, i % 32);
    const float rstd = __shfl_sync(0xffffffffu, rstd_b, i % 32);
    bulk_copy::wait(&full[warp][i % kS], (i / kS) & 1);
    const uint4* st = mine + (i % kS) * kSV;
    uint4 vs[J], vg[J], vr[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int v = j * 32 + lane;
      vs[j] = vg[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (v >= nvec) continue;
      vs[j] = st[v];
      vg[j] = st[J * 32 + v];
      if (with_gs) vr[j] = st[2 * J * 32 + v];
    }
    __syncwarp();  // every lane has read the stage before it is refilled

    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j * 32 + lane >= nvec) continue;
      float fs[kN], fg[kN];
      Vec<T>::unpack(vs[j], fs);
      Vec<T>::unpack(vg[j], fg);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xhat = (fs[e] - mean) * rstd;
        const float dxhat = fg[e] * scale[j][e];
        a1 += dxhat;
        a2 += dxhat * xhat;
        acc_w[j][e] += fg[e] * xhat;
        acc_b[j][e] += fg[e];
      }
    }
    const float m1 = warp_sum(a1) / (float)d;
    const float m2 = warp_sum(a2) / (float)d;

    T* out = static_cast<T*>(a.dx) + (size_t)(first + i * stride) * d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int v = j * 32 + lane;
      if (v >= nvec) continue;
      float fs[kN], fg[kN], fr[kN], o[kN];
      Vec<T>::unpack(vs[j], fs);
      Vec<T>::unpack(vg[j], fg);
      Vec<T>::unpack(vr[j], fr);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xhat = (fs[e] - mean) * rstd;
        const float dxhat = fg[e] * scale[j][e];
        o[e] = rstd * ((dxhat - m1) - xhat * m2);
        if (with_gs) o[e] = round_to<T>(o[e]) + fr[e];
      }
      reinterpret_cast<uint4*>(out)[v] = Vec<T>::pack(o);
    }
  }
  __syncthreads();

  // The CTA's partial: each warp's sums into its own 2 x d floats of the
  // ring (whole 16-byte vectors), then each thread adds its columns over
  // the warps in warp order.
  float* red = reinterpret_cast<float*>(ring);
  float* own = red + (size_t)warp * 2 * d;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int v = j * 32 + lane;
    if (v >= nvec) continue;
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      reinterpret_cast<uint4*>(own)[v * kN / 4 + q] = Vec<float>::pack(acc_w[j] + 4 * q);
      reinterpret_cast<uint4*>(own + d)[v * kN / 4 + q] = Vec<float>::pack(acc_b[j] + 4 * q);
    }
  }
  __syncthreads();
  float* part = a.workspace + (size_t)blockIdx.x * 2 * d;
  for (int col = threadIdx.x; col < 2 * d; col += kThreads) {
    float acc = red[col];
    for (int w = 1; w < kWarps; ++w) acc += red[(size_t)w * 2 * d + col];
    part[col] = acc;
  }
  finish(a, 2 * d);
}

// The general path, any d: a lane takes columns lane, lane + 32, ...; the
// row is read twice (sums, then ds), and each warp's dscale/dbias sums
// live in its own 2 x d slice of the workspace after the CTA partials.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_norm_bwd_general_kernel(Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = a.d;
  const bool with_gs = a.gs != nullptr;
  const T* s = static_cast<const T*>(a.s);
  const T* gy = static_cast<const T*>(a.gy);
  const T* gs = static_cast<const T*>(a.gs);
  T* dx = static_cast<T*>(a.dx);
  // Warp partials after the CTA partials and the group sums.
  const size_t warp_base = gridDim.x + (gridDim.x + a.group - 1) / a.group;
  float* mine = a.workspace + (warp_base + (size_t)blockIdx.x * kWarps + warp) * 2 * d;
  for (int col = lane; col < 2 * d; col += 32) __stcg(mine + col, 0.0f);

  const int row0 = blockIdx.x * a.rows_per_cta;
  const int row_end = min(a.n, row0 + a.rows_per_cta);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const size_t off = (size_t)r * d;
    const float mean = __ldg(a.mean + r), rstd = __ldg(a.rstd + r);
    float a1 = 0.0f, a2 = 0.0f;
    for (int col = lane; col < d; col += 32) {
      const float xhat = (to_float(s[off + col]) - mean) * rstd;
      const float dxhat = to_float(gy[off + col]) * __ldg(a.scale + col);
      a1 += dxhat;
      a2 += dxhat * xhat;
    }
    const float m1 = warp_sum(a1) / (float)d;
    const float m2 = warp_sum(a2) / (float)d;
    for (int col = lane; col < d; col += 32) {
      const float g = to_float(gy[off + col]);
      const float xhat = (to_float(s[off + col]) - mean) * rstd;
      const float dxhat = g * __ldg(a.scale + col);
      float o = rstd * ((dxhat - m1) - xhat * m2);
      if (with_gs) o = round_to<T>(o) + to_float(gs[off + col]);
      dx[off + col] = from_float<T>(o);
      __stcg(mine + col, __ldcg(mine + col) + g * xhat);
      __stcg(mine + d + col, __ldcg(mine + d + col) + g);
    }
  }
  __syncthreads();
  const float* warps = a.workspace + (warp_base + (size_t)blockIdx.x * kWarps) * 2 * d;
  float* part = a.workspace + (size_t)blockIdx.x * 2 * d;
  for (int col = threadIdx.x; col < 2 * d; col += kThreads) {
    float acc = __ldcg(warps + col);
    for (int w = 1; w < kWarps; ++w) acc += __ldcg(warps + (size_t)w * 2 * d + col);
    part[col] = acc;
  }
  finish(a, 2 * d);
}

template <typename T>
bool fast_path_ok(const Args& a) {
  constexpr int kN = Vec<T>::kN;
  const uintptr_t align = (uintptr_t)a.s | (uintptr_t)a.gy | (uintptr_t)a.gs | (uintptr_t)a.dx;
  return a.d % kN == 0 && a.d <= kMaxFastD && align % 16 == 0;
}

template <typename T, int J>
int launch_fast(const Args& a, int n_ctas, cudaStream_t stream) {
  constexpr size_t smem = kSmemBytes<J>;
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(fused_norm_bwd_kernel<T, J>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) configured[device] = true;
  }
  fused_norm_bwd_kernel<T, J><<<n_ctas, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int n_ctas, bool general, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  if (general) {
    fused_norm_bwd_general_kernel<T><<<n_ctas, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (!fast_path_ok<T>(a)) return -3;
  // Vectors a lane: the fewest instances that cover d up to 1024.
  const int per_lane = (a.d / kN + 31) / 32;
  if constexpr (kN == 8) {
    if (per_lane <= 1) return launch_fast<T, 1>(a, n_ctas, stream);
    if (per_lane <= 2) return launch_fast<T, 2>(a, n_ctas, stream);
    if (per_lane <= 3) return launch_fast<T, 3>(a, n_ctas, stream);
    return launch_fast<T, 4>(a, n_ctas, stream);
  } else {
    if (per_lane <= 2) return launch_fast<T, 2>(a, n_ctas, stream);
    if (per_lane <= 4) return launch_fast<T, 4>(a, n_ctas, stream);
    if (per_lane <= 6) return launch_fast<T, 6>(a, n_ctas, stream);
    return launch_fast<T, 8>(a, n_ctas, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (s, gy, gs, dx). gs may be null. The
// grid is n_ctas blocks of `warps` warps (which must be the kernel's),
// each owning rows_per_cta rows (every block at least one), summed in
// groups of `group` blocks. counters: kMaxCounters zeroed unsigned ints
// (ceil(n_ctas / group) + 1 are used). workspace: (n_ctas + ceil(n_ctas /
// group)) * 2 * d floats on the register path (general == 0), n_ctas *
// warps * 2 * d more on the general path. Returns the cudaError_t of the
// launch (0 on success), -1 for a dtype, -2 for a shape or grid, -3 for
// the register path asked for a width or alignment it does not take.
int fused_norm_bwd(const void* s, const void* gy, const void* gs, const void* scale,
                   const void* mean, const void* rstd, void* dx, void* workspace, void* counters,
                   void* sums, int n, int d, int n_ctas, int rows_per_cta, int group, int warps,
                   int general, int dtype, void* stream) {
  if (n < 1 || d < 1 || warps != kWarps || n_ctas < 1 || rows_per_cta < 1 || group < 1 ||
      (long long)n_ctas * rows_per_cta < n || (long long)(n_ctas - 1) * rows_per_cta >= n ||
      (n_ctas + group - 1) / group + 1 > kMaxCounters)
    return -2;
  const Args a{s, gy, gs, static_cast<const float*>(scale), static_cast<const float*>(mean),
               static_cast<const float*>(rstd), dx, static_cast<float*>(workspace),
               static_cast<unsigned int*>(counters), static_cast<float*>(sums), n, d,
               rows_per_cta, group};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, n_ctas, general != 0, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, n_ctas, general != 0, st);
  return -1;
}

const char* fused_norm_bwd_error_string(int code) {
  if (code == -1) return "unsupported dtype (float32 or bfloat16)";
  if (code == -2) return "unsupported shape or grid (n, d >= 1; every CTA owns rows)";
  if (code == -3)
    return "the register path needs d a multiple of 8 (bf16) or 4 (f32), d <= 1024 and 16-byte "
           "aligned operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
