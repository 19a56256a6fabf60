// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `pallas_flash_attention_fwd`
// (llmtrain_tpu/ops/pallas_attention.py:186, kernel body `_flash_kernel`
// at :51, pallas_call at :240): causal attention with an optional sliding
// window and an optional (B, T) segment-id mask, online softmax, returning
// O in q's layout and dtype plus the per-row logsumexp (B*H, T) in f32 in
// the natural log.
//
// Layouts (all contiguous, 16-byte aligned):
//   q    (B, T, H, D)      f32 or bf16, D in {64, 128}
//   k, v (B, T, Hkv, D)    same dtype as q, H % Hkv == 0 (GQA by index:
//                          query head h reads kv head h / (H / Hkv); K/V
//                          are never repeated in memory)
//   mask (B, T) int32      optional segment ids: a key is live for a
//                          query iff its id is nonzero and equal to the
//                          query's id
//   o    (B, T, H, D)      q's dtype
//   lse  (B*H, T)          f32
//
// Semantics kept from the Pallas kernel: the 1/sqrt(D) scale is applied in
// f32 (the bf16 instances scale S after the product, so the scale adds no
// bf16 rounding at D = 128, where it is not a power of two; the f32
// instances scale q before it, as Pallas does), products accumulate in
// f32, and dead logits get the FINITE value -1e30 (pallas_attention.py:48)
// rather than -inf, so a row whose first visited tile is entirely dead
// carries finite garbage that the running-max correction wipes as soon as
// a live key arrives.
// Rows with no live key at all are zeroed by the model afterwards. Any
// T >= 1: key tiles wholly above the diagonal, before the window or past
// the end are never visited, and the ragged tail is masked in the tile.
//
// What bounds it at the training shape, (64, 512, 12, 64) bf16 causal: it
// must move q, k, v and o once (and lse), 0.203 GB, 0.0606 ms at 3.35
// TB/s, against 2.6e10 flop of live causal pairs, 0.026 ms of bf16
// tensor-core time: bytes.
//
// bf16 instances (everything on the main path: training computes in bf16
// and serving casts its parameters to bf16) run on the tensor cores with
// mma.sync.m16n8k16 (bf16 x bf16 -> f32), fed by ldmatrix; not wgmma/TMA.
// One block of four warps per (64-row q tile, b*h), 16 query rows per
// warp, 64-key tiles:
//   * Q, K and V stay bf16 in shared memory, as in device memory, in
//     swizzled (64, D) tiles (tile_mma.cuh): ldmatrix reads them without
//     bank conflicts. Q is read into registers once as A fragments.
//   * K/V tiles arrive by cp.async into a ring of two stages: tile j + 1
//     is in flight while tile j is computed, with one __syncthreads() per
//     tile (it both publishes tile j and retires the stage tile j + 1
//     overwrites).
//   * S = Q K^T and O += P V are tensor-core MMAs. P never leaves
//     registers: the f32 accumulator fragment of S, rounded to bf16 in
//     place, is the A fragment of P V (the one new rounding, the standard
//     FlashAttention-2 point). The row sum is taken from the f32 P. Row
//     max and sum reduce over the four lanes of a quad with shuffles; the
//     exponentials run through exp2 with log2(e) folded in, on the natural
//     log's values, so lse is m + log(l) as the Pallas kernel stores it.
//   * O is normalised in registers, staged through the warp's own rows of
//     the Q tile and written in 16-byte stores.
// The f32 instances keep the first version's plain f32 FMA code (tensor
// cores would mean TF32, outside the f32 limit of 1e-4): 256 threads,
// four per query row, K/V staged as f32 in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

using tile_mma::bf16;

constexpr int kBlockM = 64;          // query rows per block
constexpr int kBlockN = 64;          // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// f32 FMA instances.
constexpr int kThreadsPerRow = 4;
constexpr int kFmaThreads = kBlockM * kThreadsPerRow;  // 256
constexpr int kKeysPerThread = kBlockN / kThreadsPerRow;  // 16

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

template <typename T>
constexpr int threads_for() { return kTensorCores<T> ? tile_mma::kThreads : kFmaThreads; }

template <int D, typename T>
constexpr size_t smem_bytes() {
  if (kTensorCores<T>)
    // sQ (64, D), sK and sV two stages each, bf16; key segment ids, two stages.
    return sizeof(bf16) * 5 * kBlockM * D + sizeof(int) * 2 * kBlockN;
  // sQ, sK, sV: (64, D+1) f32 each; sP: (64, 65) f32; key segment ids: 64 int32.
  return sizeof(float) * (3 * kBlockM * (D + 1) + kBlockM * (kBlockN + 1)) +
         sizeof(int) * kBlockN;
}

template <int D>
__device__ __forceinline__ void flash_fwd_fma(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              const int* __restrict__ mask, float* __restrict__ o,
                                              float* __restrict__ lse, int seq_len, int n_heads,
                                              int n_kv_heads, float scale, int causal,
                                              int window) {
  constexpr int kStride = D + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  extern __shared__ float smem_f32[];
  float* s_q = smem_f32;
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
  const float* q_base = q + ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
  const float* k_base = k + ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const float* v_base = v + ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;

  // Stage the scaled q tile (rows past the end read as zero).
  for (int idx = tid; idx < kBlockM * D; idx += kFmaThreads) {
    const int r = idx / D, d = idx % D;
    const int p = m0 + r;
    s_q[r * kStride + d] =
        p < seq_len ? q_base[(int64_t)p * q_row_stride + d] * scale : 0.0f;
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
    for (int idx = tid; idx < kBlockN * D; idx += kFmaThreads) {
      const int r = idx / D, d = idx % D;
      const int p = n0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (p < seq_len) {
        kx = k_base[(int64_t)p * kv_row_stride + d];
        vx = v_base[(int64_t)p * kv_row_stride + d];
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
  float* o_row = o + ((int64_t)b * seq_len + qpos) * q_row_stride + (int64_t)h * D;
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j)
    o_row[j * kThreadsPerRow + col] = acc[j] * inv;
  if (col == 0) lse[(int64_t)bh * seq_len + qpos] = row_max + logf(row_sum);
}


template <int D>
__device__ __forceinline__ void flash_fwd_mma(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const int* __restrict__ mask, bf16* __restrict__ o,
                                              float* __restrict__ lse, int seq_len, int n_heads,
                                              int n_kv_heads, float scale, int causal,
                                              int window) {
  using namespace tile_mma;
  constexpr int kTile = kBlockM * D;
  constexpr int kDT = D / 8;   // n8 tiles of O over d
  constexpr int kKS = D / 16;  // k16 steps of S over d
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kTile;      // two stages
  bf16* s_v = s_k + 2 * kTile;  // two stages
  int* s_seg = reinterpret_cast<int*>(s_v + 2 * kTile);  // two stages of 64

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int hkv = h / (n_heads / n_kv_heads);

  const int64_t q_row_stride = (int64_t)n_heads * D;
  const int64_t kv_row_stride = (int64_t)n_kv_heads * D;
  const bf16* q_base = q + ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
  const bf16* k_base = k + ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const bf16* v_base = v + ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;

  // Live key range for this tile of queries.
  int kv_end = seq_len;
  if (causal) kv_end = min(seq_len, m0 + kBlockM);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, m0 - window + 1);
  const int tile_begin = kv_start / kBlockN;
  const int tile_end = (kv_end + kBlockN - 1) / kBlockN;

  auto load_kv = [&](int tile, int stage) {
    const int n0 = tile * kBlockN;
    load_tile<D>(s_k + stage * kTile, k_base, kv_row_stride, n0, seq_len);
    load_tile<D>(s_v + stage * kTile, v_base, kv_row_stride, n0, seq_len);
    if (seg_base && tid < kBlockN) {
      const int p = n0 + tid;
      cp_async_4(smem_addr(s_seg + stage * kBlockN + tid), seg_base + (p < seq_len ? p : 0),
                 p < seq_len);
    }
  };
  load_tile<D>(s_q, q_base, q_row_stride, m0, seq_len);
  load_kv(tile_begin, 0);
  cp_async_commit();

  // This thread's two query rows: g and g + 8 of the warp's 16.
  const int row0 = warp * 16;
  const int qpos[2] = {m0 + row0 + g, m0 + row0 + g + 8};
  int q_seg[2] = {0, 0};
  if (seg_base) {
    for (int i = 0; i < 2; ++i) q_seg[i] = qpos[i] < seq_len ? seg_base[qpos[i]] : 0;
  }

  uint32_t qf[kKS][4];
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float row_max[2] = {kNegInf, kNegInf};
  float row_sum[2] = {0.0f, 0.0f};  // this thread's columns only until the end

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int stage = (tile - tile_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` is in; every warp is done with the other stage
    if (tile + 1 < tile_end) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    if (tile == tile_begin) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) load_a<D>(qf[ks], s_q, row0, ks);
    }
    const bf16* k_s = s_k + stage * kTile;
    const bf16* v_s = s_v + stage * kTile;
    const int* seg_s = s_seg + stage * kBlockN;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_rows<D>(bk, k_s, np * 16, ks);
        mma(s[2 * np], qf[ks], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    const int n0 = tile * kBlockN;
    const bool masked = seg_base || n0 + kBlockN > seq_len || (causal && n0 + kBlockN - 1 > m0) ||
                        (window > 0 && m0 + kBlockM - 1 - n0 >= window);
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (masked) {
          const int n = nt * 8 + 2 * t + (e & 1);
          const int kpos = n0 + n;
          const int qp = qpos[e >> 1];
          bool live = kpos < seq_len;
          if (causal) live = live && kpos <= qp;
          if (window > 0) live = live && (qp - kpos) < window;
          if (seg_base) live = live && seg_s[n] != 0 && seg_s[n] == q_seg[e >> 1];
          if (!live) x = kNegInf;
        }
        s[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float correction[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The four lanes of a quad hold one row.
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
      const float new_max = fmaxf(row_max[i], tile_max[i]);
      correction[i] = exp2f((row_max[i] - new_max) * kLog2e);
      row_max[i] = new_max;
      row_sum[i] *= correction[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nt][e] - row_max[e >> 1]) * kLog2e);
        s[nt][e] = p;
        row_sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= correction[0];
      acc[dt][1] *= correction[0];
      acc[dt][2] *= correction[1];
      acc[dt][3] *= correction[1];
    }

    // O += P V, P straight from the S fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        load_b_cols<D>(bv, v_s, kk * 16, dp);
        mma(acc[2 * dp], pa, bv[0], bv[1]);
        mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
    inv[i] = 1.0f / row_sum[i];
    if (t == 0 && qpos[i] < seq_len)
      lse[(int64_t)bh * seq_len + qpos[i]] = row_max[i] + logf(row_sum[i]);
  }
  // The warp's own rows of the Q tile are free: its fragments are in registers.
  store_rows<D>(s_q, acc, inv[0], inv[1], row0, o + ((int64_t)b * seq_len) * q_row_stride +
                (int64_t)h * D, q_row_stride, m0, seq_len);
}

template <int D, typename T>
__global__ void __launch_bounds__(threads_for<T>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                 int seq_len, int n_heads, int n_kv_heads, float scale, int causal, int window) {
  if constexpr (kTensorCores<T>)
    flash_fwd_mma<D>(q, k, v, mask, o, lse, seq_len, n_heads, n_kv_heads, scale, causal, window);
  else
    flash_fwd_fma<D>(q, k, v, mask, o, lse, seq_len, n_heads, n_kv_heads, scale, causal, window);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* lse, int batch, int seq_len, int n_heads, int n_kv_heads,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, T>();
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
  flash_fwd_kernel<D, T><<<grid, threads_for<T>(), smem, stream>>>(
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
