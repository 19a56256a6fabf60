// Flash-attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV.
//
// Replaces the TPU kernels of `pallas_flash_attention_bwd`
// (llmtrain_tpu/ops/pallas_attention.py:468): `_bwd_dq_kernel` (:278,
// pallas_call :531) and `_bwd_dkdv_kernel` (:358, pallas_call :573).
// FlashAttention-2's recompute scheme: the forward saved the per-row
// logsumexp L, and each kernel recomputes P = exp(S - L) tile by tile, so
// nothing of shape (T, T) is ever stored.
//
//   S  = scale * q k^T              (the scale in f32)
//   P  = exp(S - L)                 (dead logits hold the finite -1e30)
//   dP = dO v^T
//   dS = P * (dP - delta)           delta = rowsum(dO * O), computed by the
//                                   caller in f32 (as JAX computes it in
//                                   XLA outside the Pallas call)
//   dQ = scale * dS k               (the one factor of scale, at the end)
//   dV = P^T dO
//   dK = scale * dS^T q
//
// Layouts (all contiguous, 16-byte aligned): q, dO, dQ (B, T, H, D); k, v, dK, dV
// (B, T, Hkv, D) with H % Hkv == 0 (query head h reads kv head
// h / (H / Hkv)); L and delta (B*H, T) f32; mask (B, T) int32 segment ids,
// optional (a key is live for a query iff its id is nonzero and equal to
// the query's). dQ comes back in q's dtype, dK/dV in k's dtype. Any
// T >= 1: ragged tails are masked in-tile. Rows with no live key carry
// finite garbage in L; the model zeroes their output, so their dO and
// delta are zero and they contribute nothing here, as on the TPU.
//
// Design, and where it leaves the TPU's. The TPU runs the dK/dV grid
// (B*Hkv, T/BK, G) in order on one core and accumulates the G query
// heads of a kv head into one f32 output block that the grid revisits
// (pallas_attention.py:578, :457-465). Blocks on the GPU run in no order,
// so that sequential grid axis becomes a loop INSIDE the block: one block
// per (64-key tile, b*hkv) walks the G query heads of its group and,
// for each, the 64-row q tiles from the causal diagonal down (to the end
// of the sequence or of the window), accumulating dK and dV in f32
// registers and writing each once. The dQ kernel keeps the TPU's schedule
// (pallas_attention.py:531), the forward's: one block per (64-row q tile,
// b*h), looping over the K/V tiles from the window's start to the
// diagonal, dQ in f32 registers, written once. No atomics, no f32 scratch
// in HBM, and the sums run in a fixed order, so reruns are bit-identical.
//
// What bounds them at the training shape (64, 512, 12, 64) bf16 causal:
// the bytes each must move (q, k, v, dO, L and delta read once, its
// outputs written once). dK/dV: 0.305 GB, 0.0911 ms at 3.35 TB/s, against
// 5.2e10 flop of the live causal pairs (four products), 0.052 ms of bf16
// tensor-core time. dQ: 0.255 GB, 0.0761 ms, against 3.9e10 flop (three
// products: S, dP, dQ), 0.039 ms. Both: bytes.
//
// The bf16 instances (the main path's: training computes in bf16) run on
// the tensor cores with mma.sync.m16n8k16 (bf16 x bf16 -> f32) fed by
// ldmatrix; not wgmma/TMA. Four warps, 16 rows (keys for dK/dV, queries
// for dQ) per warp; tiles are bf16, as in device memory, in the swizzled
// layout of tile_mma.cuh (ldmatrix without bank conflicts, plain or
// .trans).
//   dK/dV:
//   * K and V stay in shared memory for the block's life; Q, dO, L, delta
//     and the query segment ids of each q tile arrive by cp.async into a
//     ring of two stages, so tile j + 1 loads while tile j is computed,
//     with one __syncthreads() per q tile.
//   * S^T = K Q^T and dP^T = V dO^T are MMAs with the keys as rows; P^T
//     and dS^T are formed in the accumulator registers and, rounded to
//     bf16 in place (the standard FlashAttention-2 rounding points), are
//     the A fragments of dV += P^T dO and dK += dS^T Q: nothing of P or dS
//     goes through shared memory. S^T is scaled in f32 after the product,
//     and dK takes its factor of scale on the f32 sums at the end.
//   * At D = 64 each warp holds S^T and dP^T for the whole 64-query tile;
//     at D = 128, where the dK/dV accumulators take 128 registers a
//     thread, for 32 queries at a time, which keeps ptxas free of spills.
//   dQ:
//   * Q and dO stay in shared memory for the block's life; K, V and the
//     key segment ids of each K/V tile arrive by cp.async into a ring of
//     two stages, one __syncthreads() per tile.
//   * S = Q K^T and dP = dO V^T are MMAs with the queries as rows (K and
//     V read by plain ldmatrix); dS = P (dP - delta) is formed in the f32
//     accumulator registers, rounded to bf16 in place, and is the A
//     fragment of dQ += dS K with K read by ldmatrix.trans: nothing goes
//     through shared memory. S is scaled in f32 after the product (not q
//     in bf16 before it), and dQ takes its factor of scale on the f32
//     sums at the end. L and delta of the thread's two rows stay in
//     registers.
//   * At D = 64 each warp holds S and dP for the whole 64-key tile; at
//     D = 128, where dQ takes 64 registers a thread, for 32 keys at a
//     time, as dK/dV does.
//   * Both kernels write their outputs through the warp's own rows of a
//     tile it no longer reads (K/V, Q), in 16-byte stores.
// The f32 instances keep the first version's plain f32 FMA code (tensor
// cores would mean TF32, outside the f32 limit of 1e-4): 256 threads, four
// threads per tile row, tiles staged in shared memory as f32 with rows
// padded by one float, P and dS through shared memory between the two
// products of a tile, q scaled in f32 before the dot as Pallas does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

constexpr int kTile = 64;                    // rows (queries or keys) per tile
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kTile * kThreadsPerRow;  // 256
constexpr int kColsPerThread = kTile / kThreadsPerRow;  // 16
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using tile_mma::bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Live iff the key exists, is not above the diagonal, is inside the
// window and shares the query's (nonzero) segment.
__device__ __forceinline__ bool is_live(int qpos, int kpos, int seq_len, int causal,
                                        int window, bool masked, int q_seg, int k_seg) {
  bool live = kpos < seq_len && qpos < seq_len;
  if (causal) live = live && kpos <= qpos;
  if (window > 0) live = live && (qpos - kpos) < window;
  if (masked) live = live && k_seg != 0 && k_seg == q_seg;
  return live;
}

// Stage a (64, D) tile of rows [p0, p0+64) of a (.., T, heads, D) tensor
// into shared memory as f32 times `mul`; rows past the end read as zero.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* base, int64_t row_stride,
                                           int p0, int seq_len, float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int p = p0 + r;
    dst[r * (D + 1) + d] = p < seq_len ? to_float(base[(int64_t)p * row_stride + d]) * mul : 0.0f;
  }
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

template <typename T>
constexpr int threads_for() { return kTensorCores<T> ? tile_mma::kThreads : kThreads; }

template <int D, typename T>
constexpr size_t dq_smem_bytes() {
  if (kTensorCores<T>)
    // q, dO (64, D) bf16; k, v (64, D) bf16 two stages each; key segment
    // ids, two stages.
    return sizeof(bf16) * 6 * kTile * D + sizeof(int) * 2 * kTile;
  // q (scaled), dO, k, v: (64, D+1) f32 each; dS (64, 65) f32; key segment ids.
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPStride) + sizeof(int) * kTile;
}

template <int D, typename T>
constexpr size_t dkdv_smem_bytes() {
  if (kTensorCores<T>)
    // k, v (64, D) bf16; q, dO (64, D) bf16 two stages each; L, delta and
    // query segment ids of the q tile, two stages.
    return sizeof(bf16) * 6 * kTile * D + (2 * sizeof(float) + sizeof(int)) * 2 * kTile;
  // k, v, q (scaled), dO: (64, D+1) f32 each; P and dS (64, 65) f32 each;
  // L and delta of the q tile; query segment ids.
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPStride + 2 * kTile) +
         sizeof(int) * kTile;
}

template <int D, typename T>
__device__ __forceinline__ void flash_bwd_dq_fma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ mask, T* __restrict__ dq, int seq_len, int n_heads, int n_kv_heads,
    float scale, int causal, int window) {
  constexpr int kStride = D + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kTile * kStride;
  float* s_k = s_do + kTile * kStride;
  float* s_v = s_k + kTile * kStride;
  float* s_ds = s_v + kTile * kStride;
  int* s_seg = reinterpret_cast<int*>(s_ds + kTile * kPStride);

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int col = tid % kThreadsPerRow;
  const int m0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int hkv = h / (n_heads / n_kv_heads);
  const int qpos = m0 + row;
  const bool row_valid = qpos < seq_len;

  const int64_t q_row_stride = (int64_t)n_heads * D;
  const int64_t kv_row_stride = (int64_t)n_kv_heads * D;
  const int64_t q_off = ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
  const int64_t kv_off = ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;

  stage_tile<D>(s_q, q + q_off, q_row_stride, m0, seq_len, scale);
  stage_tile<D>(s_do, dout + q_off, q_row_stride, m0, seq_len, 1.0f);
  const float row_lse = row_valid ? lse[(int64_t)bh * seq_len + qpos] : 0.0f;
  const float row_delta = row_valid ? delta[(int64_t)bh * seq_len + qpos] : 0.0f;
  const int q_seg = (seg_base && row_valid) ? seg_base[qpos] : 0;

  int kv_end = seq_len;
  if (causal) kv_end = min(seq_len, m0 + kTile);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, m0 - window + 1);
  const int tile_begin = kv_start / kTile;
  const int tile_end = (kv_end + kTile - 1) / kTile;

  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc[j] = 0.0f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int n0 = tile * kTile;
    __syncthreads();  // the previous tile's s_k/s_v/s_ds reads are done
    stage_tile<D>(s_k, k + kv_off, kv_row_stride, n0, seq_len, 1.0f);
    stage_tile<D>(s_v, v + kv_off, kv_row_stride, n0, seq_len, 1.0f);
    if (seg_base && tid < kTile) {
      const int p = n0 + tid;
      s_seg[tid] = p < seq_len ? seg_base[p] : 0;
    }
    __syncthreads();

    float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = s_q[row * kStride + d];
      const float dod = s_do[row * kStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int key = (j * kThreadsPerRow + col) * kStride + d;
        s[j] = fmaf(qd, s_k[key], s[j]);
        dp[j] = fmaf(dod, s_v[key], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int n = j * kThreadsPerRow + col;
      const bool live = is_live(qpos, n0 + n, seq_len, causal, window, seg_base != nullptr,
                                q_seg, seg_base ? s_seg[n] : 0);
      const float p = row_valid ? expf((live ? s[j] : kNegInf) - row_lse) : 0.0f;
      s_ds[row * kPStride + n] = p * (dp[j] - row_delta);
    }
    __syncthreads();  // dS of the tile complete for every row

    for (int n = 0; n < kTile; ++n) {
      const float ds = s_ds[row * kPStride + n];
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j)
        acc[j] = fmaf(ds, s_k[n * kStride + j * kThreadsPerRow + col], acc[j]);
    }
  }

  if (!row_valid) return;
  T* dq_row = dq + q_off + (int64_t)qpos * q_row_stride;
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j)
    dq_row[j * kThreadsPerRow + col] = from_float<T>(acc[j] * scale);
}

template <int D>
__device__ __forceinline__ void flash_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ mask, bf16* __restrict__ dq,
    int seq_len, int n_heads, int n_kv_heads, float scale, int causal, int window) {
  using namespace tile_mma;
  constexpr int kTileElems = kTile * D;
  constexpr int kDT = D / 8;   // n8 tiles of dQ over d
  constexpr int kKS = D / 16;  // k16 steps of S/dP over d
  // Keys per chunk of S and dP held in registers: the whole tile at D = 64;
  // at D = 128, where dQ takes 64 registers a thread, 32 at a time (loop
  // rolled), as the dK/dV kernel does.
  constexpr int kChunk = D == 64 ? 64 : 32;
  constexpr int kNT = kChunk / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_do = s_q + kTileElems;
  bf16* s_k = s_do + kTileElems;       // two stages
  bf16* s_v = s_k + 2 * kTileElems;    // two stages
  int* s_seg = reinterpret_cast<int*>(s_v + 2 * kTileElems);  // two stages of 64

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int hkv = h / (n_heads / n_kv_heads);

  const int64_t q_row_stride = (int64_t)n_heads * D;
  const int64_t kv_row_stride = (int64_t)n_kv_heads * D;
  const int64_t q_off = ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
  const int64_t kv_off = ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;

  // Key tiles this q tile can see: from the window's start to the diagonal.
  int kv_end = seq_len;
  if (causal) kv_end = min(seq_len, m0 + kTile);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, m0 - window + 1);
  const int tile_begin = kv_start / kTile;
  const int tile_end = (kv_end + kTile - 1) / kTile;

  auto load_kv = [&](int tile, int stage) {
    const int n0 = tile * kTile;
    load_tile<D>(s_k + stage * kTileElems, k + kv_off, kv_row_stride, n0, seq_len);
    load_tile<D>(s_v + stage * kTileElems, v + kv_off, kv_row_stride, n0, seq_len);
    if (seg_base && tid < kTile) {
      const int p = n0 + tid;
      cp_async_4(smem_addr(s_seg + stage * kTile + tid), seg_base + (p < seq_len ? p : 0),
                 p < seq_len);
    }
  };
  load_tile<D>(s_q, q + q_off, q_row_stride, m0, seq_len);
  load_tile<D>(s_do, dout + q_off, q_row_stride, m0, seq_len);
  load_kv(tile_begin, 0);
  cp_async_commit();

  // This thread's two query rows: g and g + 8 of the warp's 16.
  const int row0 = warp * 16;
  int qpos[2], q_seg[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = m0 + row0 + g + 8 * i;
    const bool valid = qpos[i] < seq_len;
    row_lse[i] = valid ? lse[(int64_t)bh * seq_len + qpos[i]] : 0.0f;
    row_delta[i] = valid ? delta[(int64_t)bh * seq_len + qpos[i]] : 0.0f;
    q_seg[i] = (seg_base && valid) ? seg_base[qpos[i]] : 0;
  }

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int stage = (tile - tile_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` is in; every warp is done with the other stage
    if (tile + 1 < tile_end) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    const bf16* k_s = s_k + stage * kTileElems;
    const bf16* v_s = s_v + stage * kTileElems;
    const int* seg_s = s_seg + stage * kTile;
    const int n0 = tile * kTile;
    const bool masked = seg_base || n0 + kTile > seq_len || (causal && n0 + kTile - 1 > m0) ||
                        (window > 0 && m0 + kTile - 1 - n0 >= window);

#pragma unroll 1
    for (int c = 0; c < kTile / kChunk; ++c) {
      // S = Q K^T and dP = dO V^T over this chunk's keys.
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t qa[4], oa[4];
        load_a<D>(qa, s_q, row0, ks);
        load_a<D>(oa, s_do, row0, ks);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bk[4], bv[4];
          load_b_rows<D>(bk, k_s, c * kChunk + np * 16, ks);
          load_b_rows<D>(bv, v_s, c * kChunk + np * 16, ks);
          mma(s[2 * np], qa, bk[0], bk[1]);
          mma(s[2 * np + 1], qa, bk[2], bk[3]);
          mma(dp[2 * np], oa, bv[0], bv[1]);
          mma(dp[2 * np + 1], oa, bv[2], bv[3]);
        }
      }
      // dS = P (dP - delta), P = exp(S * scale - L), in place of S.
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int n = c * kChunk + nt * 8 + 2 * t + (e & 1);
          float x = s[nt][e] * scale;
          if (masked && !is_live(qpos[i], n0 + n, seq_len, causal, window, seg_base != nullptr,
                                 q_seg[i], seg_base ? seg_s[n] : 0))
            x = kNegInf;
          const float p = exp2f((x - row_lse[i]) * kLog2e);
          s[nt][e] = p * (dp[nt][e] - row_delta[i]);
        }
      }
      // dQ += dS K, dS straight from registers, K read transposed.
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t da[4];
        c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dpair = 0; dpair < D / 16; ++dpair) {
          uint32_t bk[4];
          load_b_cols<D>(bk, k_s, c * kChunk + kk * 16, dpair);
          mma(acc[2 * dpair], da, bk[0], bk[1]);
          mma(acc[2 * dpair + 1], da, bk[2], bk[3]);
        }
      }
    }
  }

  // The warp's own rows of the Q tile are free now; dQ takes its one
  // factor of scale here, on the f32 sums.
  store_rows<D>(s_q, acc, scale, scale, row0, dq + q_off, q_row_stride, m0, seq_len);
}

template <int D, typename T>
__global__ void __launch_bounds__(threads_for<T>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ mask, T* __restrict__ dq, int seq_len,
                    int n_heads, int n_kv_heads, float scale, int causal, int window) {
  if constexpr (kTensorCores<T>)
    flash_bwd_dq_mma<D>(q, k, v, dout, lse, delta, mask, dq, seq_len, n_heads, n_kv_heads, scale,
                        causal, window);
  else
    flash_bwd_dq_fma<D, T>(q, k, v, dout, lse, delta, mask, dq, seq_len, n_heads, n_kv_heads,
                           scale, causal, window);
}

template <int D, typename T>
__device__ __forceinline__ void flash_bwd_dkdv_fma(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv, int seq_len,
    int n_heads, int n_kv_heads, float scale, int causal, int window) {
  constexpr int kStride = D + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTile * kStride;
  float* s_q = s_v + kTile * kStride;
  float* s_do = s_q + kTile * kStride;
  float* s_p = s_do + kTile * kStride;
  float* s_ds = s_p + kTile * kPStride;
  float* s_lse = s_ds + kTile * kPStride;
  float* s_delta = s_lse + kTile;
  int* s_qseg = reinterpret_cast<int*>(s_delta + kTile);

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;  // key row inside the tile
  const int col = tid % kThreadsPerRow;
  const int n0 = blockIdx.x * kTile;
  const int bkv = blockIdx.y;
  const int b = bkv / n_kv_heads;
  const int hkv = bkv % n_kv_heads;
  const int group = n_heads / n_kv_heads;
  const int kpos = n0 + row;
  const bool key_valid = kpos < seq_len;

  const int64_t q_row_stride = (int64_t)n_heads * D;
  const int64_t kv_row_stride = (int64_t)n_kv_heads * D;
  const int64_t kv_off = ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;
  const int k_seg = (seg_base && key_valid) ? seg_base[kpos] : 0;

  stage_tile<D>(s_k, k + kv_off, kv_row_stride, n0, seq_len, 1.0f);
  stage_tile<D>(s_v, v + kv_off, kv_row_stride, n0, seq_len, 1.0f);

  // Query tiles that can see this key tile: from the diagonal down, to
  // the sequence end or the last query inside the window.
  const int n_q_tiles = (seq_len + kTile - 1) / kTile;
  const int qt_begin = causal ? n0 / kTile : 0;
  int qt_end = n_q_tiles;
  if (window > 0) qt_end = min(qt_end, (n0 + kTile - 1 + window - 1) / kTile + 1);

  float acc_k[kDimsPerThread], acc_v[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) acc_k[j] = acc_v[j] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const int64_t bh = (int64_t)b * n_heads + h;
    const int64_t q_off = ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int m0 = qt * kTile;
      __syncthreads();  // the previous q tile's reads are done
      stage_tile<D>(s_q, q + q_off, q_row_stride, m0, seq_len, scale);
      stage_tile<D>(s_do, dout + q_off, q_row_stride, m0, seq_len, 1.0f);
      if (tid < kTile) {
        const int p = m0 + tid;
        const bool valid = p < seq_len;
        s_lse[tid] = valid ? lse[bh * seq_len + p] : 0.0f;
        s_delta[tid] = valid ? delta[bh * seq_len + p] : 0.0f;
        s_qseg[tid] = (seg_base && valid) ? seg_base[p] : 0;
      }
      __syncthreads();

      float s[kColsPerThread], dp[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[j] = dp[j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float kd = s_k[row * kStride + d];
        const float vd = s_v[row * kStride + d];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int qi = (j * kThreadsPerRow + col) * kStride + d;
          s[j] = fmaf(kd, s_q[qi], s[j]);
          dp[j] = fmaf(vd, s_do[qi], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int qi = j * kThreadsPerRow + col;
        const int qpos = m0 + qi;
        const bool live = is_live(qpos, kpos, seq_len, causal, window, seg_base != nullptr,
                                  s_qseg[qi], k_seg);
        const float p = qpos < seq_len ? expf((live ? s[j] : kNegInf) - s_lse[qi]) : 0.0f;
        s_p[row * kPStride + qi] = p;
        s_ds[row * kPStride + qi] = p * (dp[j] - s_delta[qi]);
      }
      __syncthreads();  // P and dS of the tile complete for every key

      for (int qi = 0; qi < kTile; ++qi) {
        const float p = s_p[row * kPStride + qi];
        const float ds = s_ds[row * kPStride + qi];
#pragma unroll
        for (int j = 0; j < kDimsPerThread; ++j) {
          const int idx = qi * kStride + j * kThreadsPerRow + col;
          acc_v[j] = fmaf(p, s_do[idx], acc_v[j]);
          acc_k[j] = fmaf(ds, s_q[idx], acc_k[j]);
        }
      }
    }
  }

  if (!key_valid) return;
  const int64_t out = kv_off + (int64_t)kpos * kv_row_stride;
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) {
    dk[out + j * kThreadsPerRow + col] = from_float<T>(acc_k[j]);
    dv[out + j * kThreadsPerRow + col] = from_float<T>(acc_v[j]);
  }
}

template <int D>
__device__ __forceinline__ void flash_bwd_dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int seq_len, int n_heads, int n_kv_heads, float scale, int causal,
    int window) {
  using namespace tile_mma;
  constexpr int kTileElems = kTile * D;
  constexpr int kDT = D / 8;   // n8 tiles of dK/dV over d
  constexpr int kKS = D / 16;  // k16 steps of S^T/dP^T over d
  // Queries per chunk of S^T and dP^T held in registers: the whole tile at
  // D = 64; at D = 128, where dK and dV take 128 registers a thread, 32,
  // one chunk at a time (unrolled, the chunks' loads interleave and ptxas
  // spills at 255 registers; rolled, it needs 251 and spills nothing).
  constexpr int kChunk = D == 64 ? 64 : 32;
  constexpr int kNT = kChunk / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_v = s_k + kTileElems;
  bf16* s_q = s_v + kTileElems;        // two stages
  bf16* s_do = s_q + 2 * kTileElems;   // two stages
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * kTileElems);  // two stages of 64
  float* s_delta = s_lse + 2 * kTile;
  int* s_qseg = reinterpret_cast<int*>(s_delta + 2 * kTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kTile;
  const int bkv = blockIdx.y;
  const int b = bkv / n_kv_heads;
  const int hkv = bkv % n_kv_heads;
  const int group = n_heads / n_kv_heads;

  const int64_t q_row_stride = (int64_t)n_heads * D;
  const int64_t kv_row_stride = (int64_t)n_kv_heads * D;
  const int64_t kv_off = ((int64_t)b * seq_len) * kv_row_stride + (int64_t)hkv * D;
  const int* seg_base = mask ? mask + (int64_t)b * seq_len : nullptr;

  // Query tiles that can see this key tile: from the diagonal down, to
  // the sequence end or the last query inside the window.
  const int n_q_tiles = (seq_len + kTile - 1) / kTile;
  const int qt_begin = causal ? n0 / kTile : 0;
  int qt_end = n_q_tiles;
  if (window > 0) qt_end = min(qt_end, (n0 + kTile - 1 + window - 1) / kTile + 1);
  const int n_qt = qt_end - qt_begin;
  const int steps = group * n_qt;  // (query head, q tile) pairs, in this order

  auto load_q = [&](int step, int stage) {
    const int h = hkv * group + step / n_qt;
    const int m0 = (qt_begin + step % n_qt) * kTile;
    const int64_t q_off = ((int64_t)b * seq_len) * q_row_stride + (int64_t)h * D;
    load_tile<D>(s_q + stage * kTileElems, q + q_off, q_row_stride, m0, seq_len);
    load_tile<D>(s_do + stage * kTileElems, dout + q_off, q_row_stride, m0, seq_len);
    if (tid < kTile) {
      const int p = m0 + tid;
      const bool live = p < seq_len;
      const int64_t row = ((int64_t)b * n_heads + h) * seq_len + (live ? p : 0);
      cp_async_4(smem_addr(s_lse + stage * kTile + tid), lse + row, live);
      cp_async_4(smem_addr(s_delta + stage * kTile + tid), delta + row, live);
      if (seg_base)
        cp_async_4(smem_addr(s_qseg + stage * kTile + tid), seg_base + (live ? p : 0), live);
    }
  };
  load_tile<D>(s_k, k + kv_off, kv_row_stride, n0, seq_len);
  load_tile<D>(s_v, v + kv_off, kv_row_stride, n0, seq_len);
  load_q(0, 0);
  cp_async_commit();

  // This thread's two key rows: g and g + 8 of the warp's 16.
  const int row0 = warp * 16;
  const int kpos[2] = {n0 + row0 + g, n0 + row0 + g + 8};
  int k_seg[2] = {0, 0};
  if (seg_base) {
    for (int i = 0; i < 2; ++i) k_seg[i] = kpos[i] < seq_len ? seg_base[kpos[i]] : 0;
  }

  float acc_k[kDT][4], acc_v[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int stage = step & 1;
    cp_async_wait<0>();
    __syncthreads();  // this step's tiles are in; every warp is done with the other stage
    if (step + 1 < steps) load_q(step + 1, stage ^ 1);
    cp_async_commit();
    const int m0 = (qt_begin + step % n_qt) * kTile;
    const bf16* q_s = s_q + stage * kTileElems;
    const bf16* do_s = s_do + stage * kTileElems;
    const float* lse_s = s_lse + stage * kTile;
    const float* delta_s = s_delta + stage * kTile;
    const int* qseg_s = s_qseg + stage * kTile;
    const bool masked = seg_base || m0 + kTile > seq_len || n0 + kTile > seq_len ||
                        (causal && m0 < n0 + kTile - 1) ||
                        (window > 0 && m0 + kTile - 1 - n0 >= window);

#pragma unroll 1
    for (int c = 0; c < kTile / kChunk; ++c) {
      // S^T = K Q^T and dP^T = V dO^T over this chunk's queries.
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t ka[4], va[4];
        load_a<D>(ka, s_k, row0, ks);
        load_a<D>(va, s_v, row0, ks);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bq[4], bo[4];
          load_b_rows<D>(bq, q_s, c * kChunk + np * 16, ks);
          load_b_rows<D>(bo, do_s, c * kChunk + np * 16, ks);
          mma(s[2 * np], ka, bq[0], bq[1]);
          mma(s[2 * np + 1], ka, bq[2], bq[3]);
          mma(dp[2 * np], va, bo[0], bo[1]);
          mma(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }
      // P^T = exp(S^T * scale - L) and dS^T = P^T (dP^T - delta), in place.
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c * kChunk + nt * 8 + 2 * t + (e & 1);
          float x = s[nt][e] * scale;
          if (masked && !is_live(m0 + qi, kpos[e >> 1], seq_len, causal, window,
                                 seg_base != nullptr, seg_base ? qseg_s[qi] : 0, k_seg[e >> 1]))
            x = kNegInf;
          const float p = exp2f((x - lse_s[qi]) * kLog2e);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[qi]);
        }
      }
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T straight from registers.
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dpair = 0; dpair < D / 16; ++dpair) {
          uint32_t bo[4], bq[4];
          load_b_cols<D>(bo, do_s, c * kChunk + kk * 16, dpair);
          load_b_cols<D>(bq, q_s, c * kChunk + kk * 16, dpair);
          mma(acc_v[2 * dpair], pa, bo[0], bo[1]);
          mma(acc_v[2 * dpair + 1], pa, bo[2], bo[3]);
          mma(acc_k[2 * dpair], da, bq[0], bq[1]);
          mma(acc_k[2 * dpair + 1], da, bq[2], bq[3]);
        }
      }
    }
  }

  // The warp's own rows of the K and V tiles are free now; dK takes its
  // one factor of scale here, on the f32 sums.
  store_rows<D>(s_k, acc_k, scale, scale, row0, dk + kv_off, kv_row_stride, n0, seq_len);
  store_rows<D>(s_v, acc_v, 1.0f, 1.0f, row0, dv + kv_off, kv_row_stride, n0, seq_len);
}

template <int D, typename T>
__global__ void __launch_bounds__(threads_for<T>())
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
                      int seq_len, int n_heads, int n_kv_heads, float scale, int causal,
                      int window) {
  if constexpr (kTensorCores<T>)
    flash_bwd_dkdv_mma<D>(q, k, v, dout, lse, delta, mask, dk, dv, seq_len, n_heads, n_kv_heads,
                          scale, causal, window);
  else
    flash_bwd_dkdv_fma<D, T>(q, k, v, dout, lse, delta, mask, dk, dv, seq_len, n_heads,
                             n_kv_heads, scale, causal, window);
}

// The shared-memory opt-in is a per-device function attribute: set it
// once per device the first time that device launches an instance.
template <typename Kernel>
cudaError_t configure_smem(Kernel kernel, size_t smem, bool* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && device < 64) configured[device] = true;
  return err;
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* mask, void* dq, int batch, int seq_len,
              int n_heads, int n_kv_heads, float scale, int causal, int window,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D, T>();
  static bool configured[64] = {};
  cudaError_t err = configure_smem(flash_bwd_dq_kernel<D, T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq_len + kTile - 1) / kTile, batch * n_heads);
  flash_bwd_dq_kernel<D, T><<<grid, threads_for<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(mask), static_cast<T*>(dq),
      seq_len, n_heads, n_kv_heads, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* mask, void* dk, void* dv, int batch,
                int seq_len, int n_heads, int n_kv_heads, float scale, int causal, int window,
                cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D, T>();
  static bool configured[64] = {};
  cudaError_t err = configure_smem(flash_bwd_dkdv_kernel<D, T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq_len + kTile - 1) / kTile, batch * n_kv_heads);
  flash_bwd_dkdv_kernel<D, T><<<grid, threads_for<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(mask), static_cast<T*>(dk),
      static_cast<T*>(dv), seq_len, n_heads, n_kv_heads, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch (0 on success); -1 for a head_dim or dtype it does not take.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* mask, void* dq,
                           int batch, int seq_len, int n_heads, int n_kv_heads, int head_dim,
                           int dtype, int causal, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ_DISPATCH(DIM, TYPE)                                                         \
  return launch_dq<DIM, TYPE>(q, k, v, dout, lse, delta, mask, dq, batch, seq_len,     \
                              n_heads, n_kv_heads, scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) DQ_DISPATCH(64, float);
  if (dtype == 0 && head_dim == 128) DQ_DISPATCH(128, float);
  if (dtype == 1 && head_dim == 64) DQ_DISPATCH(64, __nv_bfloat16);
  if (dtype == 1 && head_dim == 128) DQ_DISPATCH(128, __nv_bfloat16);
#undef DQ_DISPATCH
  return -1;
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* mask, void* dk,
                             void* dv, int batch, int seq_len, int n_heads, int n_kv_heads,
                             int head_dim, int dtype, int causal, int window, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKDV_DISPATCH(DIM, TYPE)                                                          \
  return launch_dkdv<DIM, TYPE>(q, k, v, dout, lse, delta, mask, dk, dv, batch, seq_len, \
                                n_heads, n_kv_heads, scale, causal, window, s)
  if (dtype == 0 && head_dim == 64) DKDV_DISPATCH(64, float);
  if (dtype == 0 && head_dim == 128) DKDV_DISPATCH(128, float);
  if (dtype == 1 && head_dim == 64) DKDV_DISPATCH(64, __nv_bfloat16);
  if (dtype == 1 && head_dim == 128) DKDV_DISPATCH(128, __nv_bfloat16);
#undef DKDV_DISPATCH
  return -1;
}

const char* flash_attention_bwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
