// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `pallas_flash_attention_fwd`
// (llmtrain_tpu/ops/pallas_attention.py:186, kernel body `_flash_kernel`
// at :51): causal attention with an optional sliding window and an
// optional (B, T) segment-id mask, online softmax, returning O in q's
// layout and dtype plus the per-row logsumexp (B*H, T) in f32.
//
// Layouts (all contiguous):
//   q    (B, T, H, D)      f32 or bf16
//   k, v (B, T, Hkv, D)    same dtype as q, H % Hkv == 0 (GQA by index:
//                          query head h reads kv head h / (H / Hkv); K/V
//                          are never repeated in memory)
//   mask (B, T) int32      optional segment ids: a key is live for a
//                          query iff its id is nonzero and equal to the
//                          query's id
//   o    (B, T, H, D)      q's dtype
//   lse  (B*H, T)          f32
//
// Semantics kept from the Pallas kernel: q is scaled by 1/sqrt(D) in f32
// before the dot, every product accumulates in f32, and dead logits get
// the FINITE value -1e30 (pallas_attention.py:48) rather than -inf, so a
// row whose first visited tile is entirely dead carries finite garbage
// that the running-max correction wipes as soon as a live key arrives.
// Rows with no live key at all are zeroed by the model afterwards.
//
// What bounds it at the serving path's shape, (1, 512, 12, 64) bf16
// causal: it must move ~3.2 MB (q, k, v, o once each) and do ~0.4 GFLOP,
// i.e. ~1 us of HBM time against ~0.4 us of bf16 tensor-core time: the
// bound is memory and, in practice, launch overhead. This first version
// is deliberately simple and right rather than fast: plain f32 FMA in
// registers, K/V tiles staged in shared memory (converted to f32 on the
// way in), no tensor cores, no TMA. wgmma/TMA are later work.
//
// Design: one block of 256 threads per (64-row q tile, b*h). Four
// threads share one query row; thread c of a row owns keys j*4+c of each
// 64-key tile for the scores and output columns j*4+c for the
// accumulator, so shared-memory reads are conflict-free (rows are padded
// by one float). Row max/sum reduce across the four threads with warp
// shuffles. The probabilities of a tile go through shared memory so
// each thread can multiply them against its own columns of V. Key tiles
// wholly above the causal diagonal, wholly before the window, or past
// the sequence end are never visited; the ragged tail of any T >= 1 is
// masked in-tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;          // query rows per block
constexpr int kBlockN = 64;          // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockM * kThreadsPerRow;  // 256
constexpr int kKeysPerThread = kBlockN / kThreadsPerRow;  // 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t smem_bytes(int d) {
  // sQ, sK, sV: (64, D+1) f32 each; sP: (64, 65) f32; key segment ids: 64 int32.
  return sizeof(float) * (3 * kBlockM * (d + 1) + kBlockM * (kBlockN + 1)) +
         sizeof(int) * kBlockN;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int seq_len,
                 int n_heads, int n_kv_heads, float scale, int causal,
                 int window) {
  constexpr int kStride = D + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + kBlockM * kStride;
  float* s_v = s_k + kBlockN * kStride;
  float* s_p = s_v + kBlockN * kStride;
  int* s_seg = reinterpret_cast<int*>(s_p + kBlockM * (kBlockN + 1));

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;  // query row inside the tile
  const int col = tid % kThreadsPerRow;  // which quarter of keys/dims
  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int hkv = h / (n_heads / n_kv_heads);
  const int qpos = m0 + row;
  const bool row_valid = qpos < seq_len;

  const int64_t q_row_stride = (int64_t)n_heads * D;
  const int64_t kv_row_stride = (int64_t)n_kv_heads * D;
  const T* q_base = q + ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
  const T* k_base = k + ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const T* v_base = v + ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;

  // Stage the scaled q tile (rows past the end read as zero).
  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int p = m0 + r;
    s_q[r * kStride + d] =
        p < seq_len ? to_float(q_base[(int64_t)p * q_row_stride + d]) * scale : 0.0f;
  }
  const int q_seg = (seg_base && row_valid) ? seg_base[qpos] : 0;

  // Live key range for this tile of queries.
  int kv_end = seq_len;
  if (causal) kv_end = min(seq_len, m0 + kBlockM);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, m0 - window + 1);
  const int tile_begin = kv_start / kBlockN;
  const int tile_end = (kv_end + kBlockN - 1) / kBlockN;

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.0f;
  float row_max = kNegInf;
  float row_sum = 0.0f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int n0 = tile * kBlockN;
    __syncthreads();  // previous tile's s_k/s_v/s_p reads are done
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int p = n0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (p < seq_len) {
        kx = to_float(k_base[(int64_t)p * kv_row_stride + d]);
        vx = to_float(v_base[(int64_t)p * kv_row_stride + d]);
      }
      s_k[r * kStride + d] = kx;
      s_v[r * kStride + d] = vx;
    }
    if (seg_base && tid < kBlockN) {
      const int p = n0 + tid;
      s_seg[tid] = p < seq_len ? seg_base[p] : 0;
    }
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = s_q[row * kStride + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        s[j] = fmaf(qd, s_k[(j * kThreadsPerRow + col) * kStride + d], s[j]);
    }

    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int n = j * kThreadsPerRow + col;
      const int kpos = n0 + n;
      bool live = kpos < seq_len;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && (qpos - kpos) < window;
      if (seg_base) live = live && s_seg[n] != 0 && s_seg[n] == q_seg;
      if (!live) s[j] = kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // The four threads of a row are adjacent lanes of one warp.
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float new_max = fmaxf(row_max, tile_max);
    const float correction = expf(row_max - new_max);
    float p_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = expf(s[j] - new_max);
      p_sum += p;
      s_p[row * (kBlockN + 1) + j * kThreadsPerRow + col] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    row_sum = row_sum * correction + p_sum;
    row_max = new_max;
    __syncthreads();  // s_p complete for every row

#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[j] *= correction;
    for (int n = 0; n < kBlockN; ++n) {
      const float p = s_p[row * (kBlockN + 1) + n];
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        acc[j] = fmaf(p, s_v[n * kStride + j * kThreadsPerRow + col], acc[j]);
    }
  }

  if (!row_valid) return;
  const float inv = 1.0f / row_sum;
  T* o_row = o + ((int64_t)b * seq_len + qpos) * q_row_stride + (int64_t)h * D;
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j)
    o_row[j * kThreadsPerRow + col] = from_float<T>(acc[j] * inv);
  if (col == 0) lse[(int64_t)bh * seq_len + qpos] = row_max + logf(row_sum);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* lse, int batch, int seq_len, int n_heads, int n_kv_heads,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  // The shared-memory opt-in is a per-device function attribute: set it
  // once per device the first time that device launches this instance.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) configured[device] = true;
  }
  dim3 grid((seq_len + kBlockM - 1) / kBlockM, batch * n_heads);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(o), static_cast<float*>(lse),
      seq_len, n_heads, n_kv_heads, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); -1 for a head_dim or dtype this kernel does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                        void* o, void* lse, int batch, int seq_len, int n_heads,
                        int n_kv_heads, int head_dim, int dtype, int causal,
                        int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_DISPATCH(DIM, TYPE)                                                     \
  return launch<DIM, TYPE>(q, k, v, mask, o, lse, batch, seq_len, n_heads, n_kv_heads, \
                           scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) FLASH_DISPATCH(64, float);
  if (dtype == 0 && head_dim == 128) FLASH_DISPATCH(128, float);
  if (dtype == 1 && head_dim == 64) FLASH_DISPATCH(64, __nv_bfloat16);
  if (dtype == 1 && head_dim == 128) FLASH_DISPATCH(128, __nv_bfloat16);
#undef FLASH_DISPATCH
  return -1;
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported head_dim or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
