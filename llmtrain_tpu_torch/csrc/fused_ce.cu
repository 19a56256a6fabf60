// Fused lm-head + cross-entropy for Hopper (sm_90a), written by hand:
// forward, dhidden and dW. The logits never reach device memory.
//
// Replaces the three TPU kernels of llmtrain_tpu/ops/fused_ce.py:
//   fused_ce_fwd_kernel    <- `_forward` (:260), kernel `_fwd_kernel` (:146),
//                             pallas_call at :265
//   fused_ce_bwd_dh_kernel <- `_bwd` dhidden, kernel `_bwd_dh_kernel` (:194),
//                             pallas_call at :330 (tile helper `_dlogit_tile` :180)
//   fused_ce_bwd_dw_kernel <- `_bwd` dW, kernel `_bwd_dw_kernel` (:212),
//                             pallas_call at :347
//
// Layouts (all contiguous, row-major):
//   h      (N, d)  f32 or bf16 (the compute dtype)
//   w      (V, d)  same dtype as h (the wrapper casts the f32 parameter)
//   labels (N,)    int32; -1 (or any id outside [0, V)) hits no column
//   lse, ll        (N,) f32: logsumexp over the V columns and the label
//                  logit (ll must be zeroed by the caller; a row whose
//                  label hits no column keeps 0, as in the Pallas kernel)
//   glse, g        (N,) f32: d(loss)/d(lse) and d(loss)/d(label logit)
//                  with its sign flipped, as `_bwd` computes them
//   dh_f32  (N, d) f32: dhidden, or the f32 accumulator when dh_bf16 is
//                  given, which then receives the final bf16 values
//   dw      (V, d) f32
//
// Semantics kept from the Pallas kernels: logits = h . w^T with every
// product accumulated in f32; columns >= V get the FINITE -1e30 (so they
// add exp(-1e30 - m) == 0 and never match a label); the online max/sum
// over vocab tiles; dlogit = exp(logit - lse) * glse - onehot(label) * g;
// dh sums dlogit . w over vocab tiles in order, dW sums dlogit^T . h over
// token tiles in order. No atomics: every output element is owned by one
// thread of one block, so the results are deterministic.
//
// What bounds it at the training shape, N = 32768, d = 768, V = 50257:
// the forward does 2*N*V*d = 2.53e12 flop against ~128 MB of reads
// (2.56 ms at 989 TFLOP/s bf16 vs 0.04 ms at 3.35 TB/s); dh and dW each
// recompute the logits and contract them again, 5.06e12 flop. All three
// are bound by operations. What feeds the tensor cores is L2: every
// block re-reads its own rows once per 128-row pass and the whole other
// operand once, ~59 GB from L2 per call at the forward's 64-token blocks.
//
// The f32 instances (off the main path: training computes in bf16) are
// plain f32 FMA from shared memory, simple and right rather than fast.
// The TPU keeps a (256 x d) dh block and a (512 x d) dW block in VMEM
// while a sequential grid axis revisits it; a Hopper block has 227 KB of
// shared memory, and blocks run in no order. So:
//   * The revisited grid axis becomes a loop inside the block: one block
//     per 128-token tile looping over 128-column vocab tiles (forward,
//     dh), or per 128-row vocab tile looping over 128-token tiles (dW).
//   * Each tile product is a register-blocked SGEMM: 256 threads, each
//     owning an 8 x 8 sub-tile, operands staged through shared memory in
//     32-deep chunks of d, k-major, read as float4.
//   * The f32 accumulators of dh and dW live in the output buffer in
//     device memory; after each tile the block adds its (128 x d)
//     contribution there, each thread to its own elements, and the last
//     tile writes the final dtype. The dlogit tile (128 x 128 f32) is the
//     A operand of the second product and never reaches device memory.
//
// The bf16 instances (the main path's) run every product on the tensor
// cores: mma.sync.m16n8k16 bf16 x bf16 -> f32 fed by ldmatrix from
// swizzled tiles (tile_mma.cuh), cp.async into a ring of three stages, one
// __syncthreads() per stage; not wgmma/TMA. All three are one walk,
// ce_mma::run, with the roles of tokens and vocabulary swapped between
// them: a block of eight warps owns 64 rows of one operand (64 tokens of h
// for the forward and dh: 512 blocks at N = 32768, 3.88 waves on 132 SMs;
// 64 vocab rows of W for dW: 786 blocks, 5.95 waves; one block per SM)
// and streams the other operand's rows in tiles of 512:
//   * logits (64 own x 128 streamed rows per pass, four passes per tile)
//     from 64-column chunks of d streamed through the ring. Each chunk is
//     summed on the tensor cores from zero and added to the f32 logits by
//     an FADD, so no tensor-core sum (whose additions need not round to
//     nearest) runs over more than 64 products: summing all of d = 768 in
//     one chain put dW 3.7e-5 from the f32 version, the chunks 6.2e-6.
//   * Forward: straight from the accumulator registers, each thread keeps
//     a running max and sum of exp(x - max) over the columns it holds (the
//     exponent as (x - m) log2(e) and exp2f, columns past V at -1e30); the
//     one thread whose fragment holds col == label writes the label logit.
//     The pairs are merged once, at the end: across the four lanes of a
//     quad by shuffles, across the four warps of a row through shared
//     memory. No barrier per vocab tile beyond the ring's.
//   * dh and dW: dlogit is formed in f32 from the accumulator registers
//     and written as bf16 into a (64 x 512) tile in shared memory, then
//     out (64 own rows x 128 columns of d at a time) += dlogit . streamed
//     rows over the tile's 512 rows, the streamed (64 x 128) tiles read
//     with ldmatrix.trans. The f32 sum is in registers (32 a thread),
//     summed from zero and added to the f32 output in device memory once
//     per 512-row tile, each element by its own thread in order:
//     deterministic, no atomics; the old values are loaded at the start of
//     the pass, so their latency hides behind its eight stages. That
//     read-modify-write moves 2 x 4 bytes x (rows x d) per 512 streamed
//     rows, ~20 GB at the training shape against ~79 GB for the f32 FMA
//     version's once per 128; its 192 KB per block stays in L2. dh's last
//     tile writes the bf16 output instead.
//   * dW keeps about 16 bits of dlogit as two bf16 terms, hi = bf16(x) and
//     lo = bf16(x - hi) (a second 64 x 512 tile, a third product: 7.6e12
//     flop instead of 5.06e12): dW must stay within 1e-4 of the f32
//     version, and one bf16 rounding of dlogit lands at 1.8e-3 to 2.9e-3
//     (the CPU rehearsal, tests/test_torch_fused_ce_rounding.py), the
//     split at 3.5e-6 to 4.9e-6. dh rounds dlogit once: it is held to
//     2^-7 (two bf16 ulps of its largest element), and one rounding lands
//     at 3.1e-3 to 4.1e-3 on the rehearsal, a margin of 1.9x.
//   * Each operand is staged once per product: the streamed tile twice
//     (once for the logits, once for the second product), the own rows
//     once per 128-row pass. The loads run two stages ahead, their
//     addresses kept by counters.
// Timed on an H100 SXM (700 W) at the training shape by
// tools/fused_ce_dw_variants.py, all variants in one process: forward
// 15.3-15.6 ms (164 registers), dh 32.2-32.4 ms (231), dW 35.3 ms (240),
// no spills. Not kept: the forward at two blocks per SM, 12.8 ms, spills
// at 128 registers; 256-column logits passes with two stages, forward
// 13.4, dh 31.1, dW 34.3 ms, leaves dh at 255 registers; without the
// per-chunk promotion, forward 14.2, dh 31.0, dW 33.2 ms, dW 3.6e-5 from
// the f32 version. dW with its f32 accumulator in shared memory
// (tools/fused_ce_dw_smem_acc.cu) 54.1 ms. Taking one piece out at a time
// (results wrong, timing only): no loads, forward 11.9 / dh 24.3 / dW
// 27.4 ms; no logits MMAs 6.7 / 26.4 / 29.3; no second-product MMAs
// dh 27.2 / dW 29.5; no old output values 30.0 / 31.8; no expf in dlogit
// 31.9 / 34.4: in the backward no one piece dominates, the forward waits
// on its logits MMAs.
//
// Ragged N, V and d are masked, never padded: rows past N or V read as
// zero and are not written, columns past V get -1e30 in the forward and a
// zero dlogit in the backward, d columns past d read as zero.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tile_mma.cuh"

namespace {

constexpr int kTile = 128;             // rows and columns of a logits tile
constexpr int kDepth = 32;             // d (or tile) chunk staged per step
constexpr int kLd = kTile + 4;         // padded row of a staged operand
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
// Shared memory: two staged operands, then the labels (forward) or the
// dlogit tile and the per-token vectors (backward).
constexpr int kStageFloats = 2 * kDepth * kLd;
constexpr size_t kFwdSmem = sizeof(float) * kStageFloats + sizeof(int) * kTile;
constexpr size_t kBwdSmem =
    sizeof(float) * (kStageFloats + kTile * kLd + 3 * kTile) + sizeof(int) * kTile;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kWidth = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kWidth = 8; };

// 16 bytes of T at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Rows [row0, row0 + 128) of a row-major (n_rows, k_dim) matrix, columns
// [k0, k0 + 32), into dst[k][row] (k-major). Rows past n_rows are zero.
template <typename T>
__device__ __forceinline__ void stage_kmajor(float* dst, const T* __restrict__ src,
                                             int64_t row0, int64_t n_rows, int k_dim,
                                             int k0) {
  constexpr int kVec = Vec<T>::kWidth;
  constexpr int kPerRow = kDepth / kVec;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int kk = (idx % kPerRow) * kVec;
    float vals[kVec];
    const int64_t row = row0 + r;
    if (row < n_rows) {
      load16(src + row * k_dim + k0 + kk, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[(kk + e) * kLd + r] = vals[e];
  }
}

// Rows [row0, row0 + 32) of a row-major (n_rows, n_cols) matrix, columns
// [c0, c0 + 128), into dst[row][col] (already k-major for the second
// product). Rows past n_rows and columns past n_cols are zero.
template <typename T>
__device__ __forceinline__ void stage_rowmajor(float* dst, const T* __restrict__ src,
                                               int64_t row0, int64_t n_rows, int n_cols,
                                               int c0) {
  constexpr int kVec = Vec<T>::kWidth;
  constexpr int kPerRow = kTile / kVec;
  for (int idx = threadIdx.x; idx < kDepth * kPerRow; idx += kThreads) {
    const int k = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float vals[kVec];
    const int64_t row = row0 + k;
    // n_cols is a multiple of 32 and c0 + c of kVec, so a vector is whole.
    if (row < n_rows && c0 + c < n_cols) {
      load16(src + row * n_cols + c0 + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[k * kLd + c + e] = vals[e];
  }
}

// Local row (or column) of a thread's i-th (or j-th) element.
__device__ __forceinline__ int sub(int lane_group, int i) {
  return (i < 4 ? 0 : 64) + lane_group * 4 + (i & 3);
}

// acc[i][j] += sum_k a[k][sub(ty, i)] * b[k][sub(tx, j)] over one chunk.
__device__ __forceinline__ void fma_chunk(const float* a, const float* b, float (&acc)[8][8],
                                          int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kDepth; ++k) {
    float av[8], bv[8];
    load16(a + k * kLd + ty * 4, av);
    load16(a + k * kLd + 64 + ty * 4, av + 4);
    load16(b + k * kLd + tx * 4, bv);
    load16(b + k * kLd + 64 + tx * 4, bv + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc = rows [a0, a0+128) of a  .  rows [b0, b0+128) of b ^T, contracted
// over all d columns: the logits tile (or its transpose, for dW).
template <typename T>
__device__ __forceinline__ void tile_logits(float* s_a, float* s_b, const T* __restrict__ a,
                                            int64_t a0, int64_t a_rows,
                                            const T* __restrict__ b, int64_t b0,
                                            int64_t b_rows, int d, float (&acc)[8][8],
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += kDepth) {
    __syncthreads();  // the previous chunk's reads are done
    stage_kmajor(s_a, a, a0, a_rows, d, k0);
    stage_kmajor(s_b, b, b0, b_rows, d, k0);
    __syncthreads();
    fma_chunk(s_a, s_b, acc, ty, tx);
  }
}

// out[own rows, :] (+)= P . x[x0 .. x0+128, :], with P the dlogit tile in
// s_p (k-major: s_p[k][own row]). The block's own rows start at out_row0;
// out is (out_rows, d) f32. first: store instead of add. last: write the
// final values to out_bf16 (when given) instead of out.
template <typename T>
__device__ __forceinline__ void accumulate_product(
    float* s_b, const float* s_p, const T* __restrict__ x, int64_t x0, int64_t x_rows,
    float* __restrict__ out, __nv_bfloat16* __restrict__ out_bf16, int64_t out_row0,
    int64_t out_rows, int d, bool first, bool last, int ty, int tx) {
  for (int n0 = 0; n0 < d; n0 += kTile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < kTile; k0 += kDepth) {
      __syncthreads();
      stage_rowmajor(s_b, x, x0 + k0, x_rows, d, n0);
      __syncthreads();
      fma_chunk(s_p + k0 * kLd, s_b, acc, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = out_row0 + sub(ty, i);
      if (row >= out_rows) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = n0 + half * 64 + tx * 4;
        if (col >= d) continue;  // d is a multiple of 32: four columns are whole
        float* dst = out + row * d + col;
        float4 v = make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                               acc[i][half * 4 + 3]);
        if (!first) {
          const float4 old = *reinterpret_cast<const float4*>(dst);
          v.x += old.x; v.y += old.y; v.z += old.z; v.w += old.w;
        }
        if (last && out_bf16 != nullptr) {
          __nv_bfloat16* o = out_bf16 + row * d + col;
          o[0] = __float2bfloat16(v.x);
          o[1] = __float2bfloat16(v.y);
          o[2] = __float2bfloat16(v.z);
          o[3] = __float2bfloat16(v.w);
        } else {
          *reinterpret_cast<float4*>(dst) = v;
        }
      }
    }
  }
}

// Token vectors of tokens [t0, t0 + 128) into shared memory (zero, and
// label -1, past N).
__device__ __forceinline__ void stage_tokens(float* s_lse, float* s_glse, float* s_g,
                                             int* s_lab, const float* __restrict__ lse,
                                             const float* __restrict__ glse,
                                             const float* __restrict__ g,
                                             const int* __restrict__ labels, int64_t t0,
                                             int64_t n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int64_t t = t0 + r;
    const bool ok = t < n;
    s_lse[r] = ok ? lse[t] : 0.0f;
    s_glse[r] = ok ? glse[t] : 0.0f;
    s_g[r] = ok ? g[t] : 0.0f;
    s_lab[r] = ok ? labels[t] : -1;
  }
}

// dlogit of one element: exp(logit - lse) * glse - [label hit] * g.
__device__ __forceinline__ float dlogit(float logit, float lse, float glse, float g, bool hit) {
  return expf(logit - lse) * glse - (hit ? g : 0.0f);
}

template <typename T>
__device__ __forceinline__ void fwd_fma(const T* __restrict__ h, const T* __restrict__ w,
                                        const int* __restrict__ labels, float* __restrict__ lse,
                                        float* __restrict__ ll, int n, int v, int d) {
  extern __shared__ float smem[];
  float* s_a = smem;
  float* s_b = s_a + kDepth * kLd;
  int* s_lab = reinterpret_cast<int*>(s_b + kDepth * kLd);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;  // the 16 threads of one ty are adjacent lanes
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  for (int r = threadIdx.x; r < kTile; r += kThreads) s_lab[r] = t0 + r < n ? labels[t0 + r] : -1;
  // (tile_logits starts with a barrier, so the labels are visible.)

  float m[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    s[i] = 0.0f;
  }
  float acc[8][8];
  for (int c0 = 0; c0 < v; c0 += kTile) {
    tile_logits(s_a, s_b, h, t0, n, w, c0, v, d, acc, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lab = s_lab[sub(ty, i)];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + sub(tx, j);
        if (col >= v) acc[i][j] = kNegInf;
        tile_max = fmaxf(tile_max, acc[i][j]);
        if (col < v && col == lab) ll[t0 + sub(ty, i)] = acc[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float new_max = fmaxf(m[i], tile_max);
      float p_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) p_sum += expf(acc[i][j] - new_max);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      s[i] = s[i] * expf(m[i] - new_max) + p_sum;
      m[i] = new_max;
    }
  }
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t t = t0 + sub(ty, i);
    if (t < n) lse[t] = m[i] + logf(s[i]);
  }
}

// Shared-memory carve-up of the backward kernels.
struct BwdSmem {
  float* a;
  float* b;
  float* p;
  float* lse;
  float* glse;
  float* g;
  int* lab;
};

__device__ __forceinline__ BwdSmem carve(float* smem) {
  BwdSmem s;
  s.a = smem;
  s.b = s.a + kDepth * kLd;
  s.p = s.b + kDepth * kLd;
  s.lse = s.p + kTile * kLd;
  s.glse = s.lse + kTile;
  s.g = s.glse + kTile;
  s.lab = reinterpret_cast<int*>(s.g + kTile);
  return s;
}

template <typename T>
__device__ __forceinline__ void bwd_dh_fma(const T* __restrict__ h, const T* __restrict__ w,
                                           const int* __restrict__ labels,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ glse,
                                           const float* __restrict__ g, float* __restrict__ dh,
                                           __nv_bfloat16* __restrict__ dh_bf16, int n, int v,
                                           int d) {
  extern __shared__ float smem[];
  const BwdSmem sm = carve(smem);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  stage_tokens(sm.lse, sm.glse, sm.g, sm.lab, lse, glse, g, labels, t0, n);
  // (tile_logits starts with a barrier, so the token vectors are visible.)

  float acc[8][8];
  for (int c0 = 0; c0 < v; c0 += kTile) {
    // Rows: tokens of this block; columns: vocab c0 .. c0+127.
    tile_logits(sm.a, sm.b, h, t0, n, w, c0, v, d, acc, ty, tx);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = sub(tx, j);
      const int col = c0 + c;
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = sub(ty, i);
        p[i] = (col < v && t0 + r < n)
                   ? dlogit(acc[i][j], sm.lse[r], sm.glse[r], sm.g[r], col == sm.lab[r])
                   : 0.0f;
      }
      // s_p[vocab][token]: the A operand of dh += P . W_tile.
      *reinterpret_cast<float4*>(sm.p + c * kLd + ty * 4) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(sm.p + c * kLd + 64 + ty * 4) =
          make_float4(p[4], p[5], p[6], p[7]);
    }
    // (accumulate_product starts with a barrier, so s_p is complete.)
    accumulate_product(sm.b, sm.p, w, c0, v, dh, dh_bf16, t0, n, d, c0 == 0,
                       c0 + kTile >= v, ty, tx);
  }
}

template <typename T>
__device__ __forceinline__ void bwd_dw_fma(const T* __restrict__ h, const T* __restrict__ w,
                                           const int* __restrict__ labels,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ glse,
                                           const float* __restrict__ g, float* __restrict__ dw,
                                           int n, int v, int d) {
  extern __shared__ float smem[];
  const BwdSmem sm = carve(smem);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t v0 = (int64_t)blockIdx.x * kTile;

  float acc[8][8];
  for (int64_t t0 = 0; t0 < n; t0 += kTile) {
    // The previous tile's last reads of the token vectors came before the
    // barriers of its accumulate_product, so they may be overwritten now.
    stage_tokens(sm.lse, sm.glse, sm.g, sm.lab, lse, glse, g, labels, t0, n);
    // Rows: vocab of this block; columns: tokens t0 .. t0+127 (logits^T).
    tile_logits(sm.a, sm.b, w, v0, v, h, t0, n, d, acc, ty, tx);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = sub(tx, j);  // token within the tile
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t vocab = v0 + sub(ty, i);
        p[i] = (vocab < v && t0 + c < n)
                   ? dlogit(acc[i][j], sm.lse[c], sm.glse[c], sm.g[c], vocab == sm.lab[c])
                   : 0.0f;
      }
      // s_p[token][vocab]: the A operand of dW += P^T . h_tile.
      *reinterpret_cast<float4*>(sm.p + c * kLd + ty * 4) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(sm.p + c * kLd + 64 + ty * 4) =
          make_float4(p[4], p[5], p[6], p[7]);
    }
    accumulate_product(sm.b, sm.p, h, t0, n, dw, static_cast<__nv_bfloat16*>(nullptr), v0, v,
                       d, t0 == 0, false, ty, tx);
  }
}

// ------------------------------------- forward, dh and dW, bf16, on the tensor cores
namespace ce_mma {

using tile_mma::bf16;

// Which of the three functions a block computes. A block owns kRows rows
// of one operand (tokens of h for the forward and dh, vocab rows of W for
// dW) and streams the other operand's rows (vocab rows for the forward and
// dh, tokens for dW) in tiles of kCols.
enum class Kind { kFwd, kDh, kDw };

constexpr int kRows = 64;       // own rows per block
constexpr int kCols = 512;      // streamed rows per tile (per f32 sum into the output)
constexpr int kPass = 128;      // streamed rows per logits product
constexpr int kWarpCols = kPass / 4;  // of them per warp (four warps along the streamed rows)
constexpr int kNT = kWarpCols / 8;    // n8 tiles of a warp's logits
constexpr int kDChunk = 64;     // d columns per stage of the logits product
constexpr int kOutCols = 128;   // d columns per accumulator pass of the second product
constexpr int kKRows = 64;      // streamed rows per stage of the second product
constexpr int kStages = 3;
constexpr int kStageElems = kRows * kDChunk + kPass * kDChunk;  // an own and a streamed chunk
constexpr int kDlElems = kRows * kCols;
static_assert(kKRows * kOutCols <= kStageElems, "a second-product stage fits a ring slot");
constexpr float kLog2e = 1.4426950408889634f;

// dlogit tiles in shared memory: hi and lo for dW, hi alone for dh.
template <Kind K>
constexpr int kDlTiles = K == Kind::kDw ? 2 : K == Kind::kDh ? 1 : 0;
// Entries of the token vectors in shared memory: a streamed tile's tokens
// for dW, the block's own tokens otherwise.
template <Kind K>
constexpr int kVecs = K == Kind::kDw ? kCols : kRows;
template <Kind K>
constexpr size_t kSmem = sizeof(bf16) * (kDlTiles<K> * kDlElems + kStages * kStageElems) +
                         (3 * sizeof(float) + sizeof(int)) * kVecs<K> +
                         (K == Kind::kFwd ? sizeof(float2) * 4 * kRows : 0);

// Merges the running (max, sum) pair (m_b, s_b) into (m, s); sums are of
// exp(x - max), a max of -1e30 marks columns that were all dead.
__device__ __forceinline__ void merge_lse(float& m, float& s, float m_b, float s_b) {
  const float mx = fmaxf(m, m_b);
  s = s * exp2f((m - mx) * kLog2e) + s_b * exp2f((m_b - mx) * kLog2e);
  m = mx;
}

// The forward (lse and the label logit), dh (out = dh in f32, out_bf16 the
// final bf16 values when given) or dW (out = dw). lse_out and ll are the
// forward's outputs; lse, glse and g the backward's inputs.
template <Kind K>
__device__ __forceinline__ void run(const bf16* __restrict__ h, const bf16* __restrict__ w,
                                    const int* __restrict__ labels,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ glse,
                                    const float* __restrict__ g, float* __restrict__ out,
                                    bf16* __restrict__ out_bf16, float* __restrict__ lse_out,
                                    float* __restrict__ ll, int n, int v, int d) {
  using tile_mma::cp_async_16;
  using tile_mma::load_a;
  using tile_mma::load_b_cols;
  using tile_mma::load_b_rows;
  using tile_mma::mma;
  using tile_mma::smem_addr;
  using tile_mma::swizzle;
  constexpr bool kDw = K == Kind::kDw;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_hi = reinterpret_cast<bf16*>(smem_raw);  // dlogit (own, streamed), hi part
  bf16* s_lo = s_hi + kDlElems;                     // and lo part (dW only)
  bf16* s_ring = s_hi + kDlTiles<K> * kDlElems;
  float* s_lse = reinterpret_cast<float*>(s_ring + kStages * kStageElems);
  float* s_glse = s_lse + kVecs<K>;
  float* s_g = s_glse + kVecs<K>;
  int* s_lab = reinterpret_cast<int*>(s_g + kVecs<K>);

  const bf16* own = kDw ? w : h;
  const bf16* str = kDw ? h : w;
  const int own_n = kDw ? v : n;
  const int str_n = kDw ? n : v;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int n_dc = (d + kDChunk - 1) / kDChunk;    // logits stages per pass
  const int n_oc = (d + kOutCols - 1) / kOutCols;  // second-product accumulator passes
  constexpr int kKSteps = kCols / kKRows;          // stages per accumulator pass
  const int n_tiles = (str_n + kCols - 1) / kCols;

  // The token vectors of tokens [t0, t0 + kVecs), zero (label -1) past N.
  auto stage_vectors = [&](int64_t t0) {
    for (int i = tid; i < kVecs<K>; i += kThreads) {
      const int64_t t = t0 + i;
      const bool ok = t < n;
      if constexpr (K != Kind::kFwd) {
        s_lse[i] = ok ? lse[t] : 0.0f;
        s_glse[i] = ok ? glse[t] : 0.0f;
        s_g[i] = ok ? g[t] : 0.0f;
      }
      s_lab[i] = ok ? labels[t] : -1;
    }
  };

  // The loads run kStages - 1 steps ahead of the compute along the same
  // fixed schedule: per streamed tile, the own and streamed chunks of the
  // logits passes (pass, dc), then (dh and dW) the streamed tiles of the
  // second product's passes (oc, kt). Counters track the position (no
  // division per step); this thread copies the 16-byte chunk lc of rows
  // lr + 32 j of a logits stage and chunk pc of rows pr + 16 j of a
  // second-product stage; rows past their count and columns past d are
  // zero-filled.
  const int lr = tid >> 3, lc = tid & 7;
  const int pr = tid >> 4, pc = tid & 15;
  int ld_tile = 0, ld_phase = 0, ld_a = 0, ld_b = 0, ld_slot = 0;
  auto issue_next = [&]() {
    if (ld_tile < n_tiles) {
      bf16* dst = s_ring + ld_slot * kStageElems;
      const int64_t c0 = (int64_t)ld_tile * kCols;
      if (ld_phase == 0) {
        const int col = ld_b * kDChunk + 8 * lc;
#pragma unroll
        for (int j = 0; j < kRows / 32; ++j) {
          const int r = lr + 32 * j;
          const int64_t row = r0 + r;
          const bool ok = col < d && row < own_n;
          cp_async_16(smem_addr(dst + swizzle<kDChunk>(r, lc)), ok ? own + row * d + col : own,
                      ok);
        }
#pragma unroll
        for (int j = 0; j < kPass / 32; ++j) {
          const int r = lr + 32 * j;
          const int64_t row = c0 + ld_a * kPass + r;
          const bool ok = col < d && row < str_n;
          cp_async_16(smem_addr(dst + kRows * kDChunk + swizzle<kDChunk>(r, lc)),
                      ok ? str + row * d + col : str, ok);
        }
        if (++ld_b == n_dc) {
          ld_b = 0;
          if (++ld_a == kCols / kPass) {
            ld_a = 0;
            if constexpr (K == Kind::kFwd)
              ++ld_tile;
            else
              ld_phase = 1;
          }
        }
      } else {
        const int col = ld_a * kOutCols + 8 * pc;
#pragma unroll
        for (int j = 0; j < kKRows / 16; ++j) {
          const int r = pr + 16 * j;
          const int64_t row = c0 + ld_b * kKRows + r;
          const bool ok = col < d && row < str_n;
          cp_async_16(smem_addr(dst + swizzle<kOutCols>(r, pc)), ok ? str + row * d + col : str,
                      ok);
        }
        if (++ld_b == kKSteps) {
          ld_b = 0;
          if (++ld_a == n_oc) ld_a = 0, ld_phase = 0, ++ld_tile;
        }
      }
      ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
    }
    tile_mma::cp_async_commit();
  };
  // One barrier per step: it publishes this step's slot and retires the
  // slot that the load issued next overwrites.
  int slot = 0;
  auto advance = [&]() -> const bf16* {
    tile_mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    issue_next();
    const bf16* stage = s_ring + slot * kStageElems;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    return stage;
  };
  // The forward and dh read the own tokens' vectors; the first advance()
  // publishes them.
  if constexpr (!kDw) stage_vectors(r0);
  for (int i = 0; i < kStages - 1; ++i) issue_next();

  // The forward's running max and sum of exp(logit - max) of this thread's
  // four rows (mt, half) over the columns it holds.
  float run_m[2][2], run_s[2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) run_m[i >> 1][i & 1] = kNegInf, run_s[i >> 1][i & 1] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int64_t c0 = (int64_t)tile * kCols;
    // (dW) The previous tile's last reads of the token vectors came before
    // the barriers of its second-product passes.
    if constexpr (kDw) stage_vectors(c0);

    // logits (own x streamed), kRows x kPass per pass; warp (wo, ws) owns
    // rows 32 wo .. +32 and kWarpCols streamed rows from kWarpCols * ws.
    // Each 64-column chunk of d is summed on the tensor cores from zero and
    // added to the f32 logits with an FADD, so no MMA sum runs longer than
    // 64 products.
    const int wo = warp & 1, ws = warp >> 1;
    for (int pass = 0; pass < kCols / kPass; ++pass) {
      float logit[2][kNT][4];
      for (int dc = 0; dc < n_dc; ++dc) {
        const bf16* own_s = advance();
        const bf16* str_s = own_s + kRows * kDChunk;
        float part[2][kNT][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kDChunk / 16; ++ks) {
          uint32_t a[2][4];
          load_a<kDChunk>(a[0], own_s, 32 * wo, ks);
          load_a<kDChunk>(a[1], own_s, 32 * wo + 16, ks);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t b[4];
            load_b_rows<kDChunk>(b, str_s, kWarpCols * ws + 16 * np, ks);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma(part[mt][2 * np], a[mt], b[0], b[1]);
              mma(part[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              logit[mt][nt][e] = dc == 0 ? part[mt][nt][e] : logit[mt][nt][e] + part[mt][nt][e];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 32 * wo + 16 * mt + gq + 8 * half;
          const bool own_ok = r0 + row < own_n;
          if constexpr (K == Kind::kFwd) {
            // Online max and sum over this thread's columns; columns past V
            // get -1e30. The one thread holding col == label writes it.
            float x[kNT][2];
            float tile_max = kNegInf;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int64_t col = c0 + pass * kPass + kWarpCols * ws + 8 * nt + 2 * tq + j;
                x[nt][j] = col < v ? logit[mt][nt][2 * half + j] : kNegInf;
                tile_max = fmaxf(tile_max, x[nt][j]);
                if (col < v && col == s_lab[row] && own_ok) ll[r0 + row] = x[nt][j];
              }
            }
            const float mx = fmaxf(run_m[mt][half], tile_max);
            float p = 0.0f;
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int j = 0; j < 2; ++j) p += exp2f((x[nt][j] - mx) * kLog2e);
            run_s[mt][half] = run_s[mt][half] * exp2f((run_m[mt][half] - mx) * kLog2e) + p;
            run_m[mt][half] = mx;
          } else {
            // dlogit in f32, rounded to bf16 (dW: split into hi = bf16(x)
            // and lo = bf16(x - hi)), into the (own, streamed) tiles that
            // feed the second product.
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const int sc = pass * kPass + kWarpCols * ws + 8 * nt + 2 * tq;  // even
              float x[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int vi = kDw ? sc + j : row;  // token vector entry
                const int64_t vocab = kDw ? r0 + row : c0 + sc + j;
                x[j] = (own_ok && c0 + sc + j < str_n)
                           ? dlogit(logit[mt][nt][2 * half + j], s_lse[vi], s_glse[vi], s_g[vi],
                                    vocab == s_lab[vi])
                           : 0.0f;
              }
              const __nv_bfloat162 hi = __floats2bfloat162_rn(x[0], x[1]);
              const int off = swizzle<kCols>(row, sc >> 3) + (sc & 7);
              *reinterpret_cast<__nv_bfloat162*>(s_hi + off) = hi;
              if constexpr (kDw) {
                const float2 hf = __bfloat1622float2(hi);
                *reinterpret_cast<__nv_bfloat162*>(s_lo + off) =
                    __floats2bfloat162_rn(x[0] - hf.x, x[1] - hf.y);
              }
            }
          }
        }
      }
    }
    if constexpr (K == Kind::kFwd) continue;

    // out[own rows, 128-column pass] (+)= dlogit . streamed over the tile's
    // 512 streamed rows (dW: hi and lo parts into one f32 accumulator);
    // warp (wr, wd) owns rows 16 wr .. +16 and columns 64 wd .. +64 of the
    // pass. (The first advance() below publishes the dlogit tiles.)
    const int wr = warp & 3, wd = warp >> 2;
    const bool last = tile + 1 == n_tiles && out_bf16 != nullptr;
    for (int oc = 0; oc < n_oc; ++oc) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      float2 old[8][2];
      for (int kt = 0; kt < kKSteps; ++kt) {
        const bf16* str_s = advance();
        if (kt == 0) {
          // The earlier tiles' sums of this thread's elements, loaded now
          // and added at the end of the pass: the loads fly meanwhile.
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = oc * kOutCols + 64 * wd + 8 * nt + 2 * tq;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int64_t row = r0 + 16 * wr + gq + 8 * half;
              old[nt][half] = (tile > 0 && col < d && row < own_n)
                                  ? *reinterpret_cast<const float2*>(out + row * d + col)
                                  : make_float2(0.0f, 0.0f);
            }
          }
        }
#pragma unroll
        for (int ks = 0; ks < kKRows / 16; ++ks) {
          uint32_t ah[4], al[4];
          load_a<kCols>(ah, s_hi, 16 * wr, kt * (kKRows / 16) + ks);
          if constexpr (kDw) load_a<kCols>(al, s_lo, 16 * wr, kt * (kKRows / 16) + ks);
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            uint32_t b[4];
            load_b_cols<kOutCols>(b, str_s, 16 * ks, 4 * wd + dp);
            mma(acc[2 * dp], ah, b[0], b[1]);
            mma(acc[2 * dp + 1], ah, b[2], b[3]);
            if constexpr (kDw) {
              mma(acc[2 * dp], al, b[0], b[1]);
              mma(acc[2 * dp + 1], al, b[2], b[3]);
            }
          }
        }
      }
      // Add this tile's sums into out in f32: each element is this
      // thread's alone, and the tiles come in order. The last tile of dh
      // writes the bf16 output instead.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = oc * kOutCols + 64 * wd + 8 * nt + 2 * tq;
        if (col >= d) continue;  // d is a multiple of 32: both columns are in
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t row = r0 + 16 * wr + gq + 8 * half;
          if (row >= own_n) continue;
          const float2 sum = make_float2(old[nt][half].x + acc[nt][2 * half],
                                         old[nt][half].y + acc[nt][2 * half + 1]);
          if (last)
            *reinterpret_cast<__nv_bfloat162*>(out_bf16 + row * d + col) =
                __floats2bfloat162_rn(sum.x, sum.y);
          else
            *reinterpret_cast<float2*>(out + row * d + col) = sum;
        }
      }
    }
  }

  if constexpr (K == Kind::kFwd) {
    // Merge the running pairs: the four lanes of a quad hold one row's
    // columns within a warp, the four warps ws its column ranges.
    float2* s_part = reinterpret_cast<float2*>(s_lab + kVecs<K>);  // [ws][row]
    const int wo = warp & 1, ws = warp >> 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float& m = run_m[i >> 1][i & 1];
      float& s = run_s[i >> 1][i & 1];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        merge_lse(m, s, __shfl_xor_sync(0xffffffffu, m, off),
                  __shfl_xor_sync(0xffffffffu, s, off));
      if (tq == 0) s_part[ws * kRows + 32 * wo + 16 * (i >> 1) + gq + 8 * (i & 1)] =
          make_float2(m, s);
    }
    __syncthreads();
    if (tid < kRows && r0 + tid < n) {
      float m = kNegInf, s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) merge_lse(m, s, s_part[j * kRows + tid].x, s_part[j * kRows + tid].y);
      lse_out[r0 + tid] = m + logf(s);
    }
  }
}

}  // namespace ce_mma

// The bf16 instances run on the tensor cores (ce_mma), the f32 ones the
// FMA code above.
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
__global__ void __launch_bounds__(kThreads, kTensorCores<T> ? 1 : 2)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ ll, int n, int v, int d) {
  if constexpr (kTensorCores<T>)
    ce_mma::run<ce_mma::Kind::kFwd>(h, w, labels, nullptr, nullptr, nullptr, nullptr, nullptr,
                                     lse, ll, n, v, d);
  else
    fwd_fma<T>(h, w, labels, lse, ll, n, v, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kTensorCores<T> ? 1 : 2)
fused_ce_bwd_dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
                       const int* __restrict__ labels, const float* __restrict__ lse,
                       const float* __restrict__ glse, const float* __restrict__ g,
                       float* __restrict__ dh, __nv_bfloat16* __restrict__ dh_bf16, int n,
                       int v, int d) {
  if constexpr (kTensorCores<T>)
    ce_mma::run<ce_mma::Kind::kDh>(h, w, labels, lse, glse, g, dh, dh_bf16, nullptr, nullptr, n,
                                    v, d);
  else
    bwd_dh_fma<T>(h, w, labels, lse, glse, g, dh, dh_bf16, n, v, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kTensorCores<T> ? 1 : 2)
fused_ce_bwd_dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
                       const int* __restrict__ labels, const float* __restrict__ lse,
                       const float* __restrict__ glse, const float* __restrict__ g,
                       float* __restrict__ dw, int n, int v, int d) {
  if constexpr (kTensorCores<T>)
    ce_mma::run<ce_mma::Kind::kDw>(h, w, labels, lse, glse, g, dw, nullptr, nullptr, nullptr, n,
                                    v, d);
  else
    bwd_dw_fma<T>(h, w, labels, lse, glse, g, dw, n, v, d);
}

// The shared-memory opt-in is a per-device function attribute: set it once
// per device the first time that device launches the instance.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, bool* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && device < 64) configured[device] = true;
  return err;
}

// Shared memory and own rows per block of each instance.
template <typename T, ce_mma::Kind K>
constexpr size_t kSmemOf = kTensorCores<T> ? ce_mma::kSmem<K>
                           : K == ce_mma::Kind::kFwd ? kFwdSmem : kBwdSmem;
template <typename T>
constexpr int kRowsOf = kTensorCores<T> ? ce_mma::kRows : kTile;

template <typename T>
int launch_fwd(const void* h, const void* w, const int* labels, float* lse, float* ll, int n,
               int v, int d, cudaStream_t stream) {
  constexpr size_t smem = kSmemOf<T, ce_mma::Kind::kFwd>;
  static bool configured[64] = {};
  cudaError_t err = opt_in(fused_ce_fwd_kernel<T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRowsOf<T> - 1) / kRowsOf<T>);
  fused_ce_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, ll, n, v, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* h, const void* w, const int* labels, const float* lse,
              const float* glse, const float* g, float* dh, void* dh_bf16, int n, int v, int d,
              cudaStream_t stream) {
  constexpr size_t smem = kSmemOf<T, ce_mma::Kind::kDh>;
  static bool configured[64] = {};
  cudaError_t err = opt_in(fused_ce_bwd_dh_kernel<T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRowsOf<T> - 1) / kRowsOf<T>);
  fused_ce_bwd_dh_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, glse, g, dh,
      static_cast<__nv_bfloat16*>(dh_bf16), n, v, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* h, const void* w, const int* labels, const float* lse,
              const float* glse, const float* g, float* dw, int n, int v, int d,
              cudaStream_t stream) {
  constexpr size_t smem = kSmemOf<T, ce_mma::Kind::kDw>;
  static bool configured[64] = {};
  cudaError_t err = opt_in(fused_ce_bwd_dw_kernel<T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((v + kRowsOf<T> - 1) / kRowsOf<T>);
  fused_ce_bwd_dw_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, glse, g, dw, n, v, d);
  return (int)cudaGetLastError();
}

bool shape_ok(int n, int v, int d) { return n >= 1 && v >= 1 && d >= 32 && d % 32 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of the
// launch (0 on success), -1 for a dtype it does not take, -2 for a shape.

int fused_ce_fwd(const void* h, const void* w, const void* labels, void* lse, void* ll, int n,
                 int v, int d, int dtype, void* stream) {
  if (!shape_ok(n, v, d)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lse_f = static_cast<float*>(lse);
  float* ll_f = static_cast<float*>(ll);
  if (dtype == 0) return launch_fwd<float>(h, w, lab, lse_f, ll_f, n, v, d, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(h, w, lab, lse_f, ll_f, n, v, d, s);
  return -1;
}

// dh_bf16 may be null: then dh (f32) is the output. Otherwise dh is the f32
// accumulator and dh_bf16 receives dhidden in bf16.
int fused_ce_bwd_dh(const void* h, const void* w, const void* labels, const void* lse,
                    const void* glse, const void* g, void* dh, void* dh_bf16, int n, int v,
                    int d, int dtype, void* stream) {
  if (!shape_ok(n, v, d)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lse_f = static_cast<const float*>(lse);
  const float* glse_f = static_cast<const float*>(glse);
  const float* g_f = static_cast<const float*>(g);
  float* dh_f = static_cast<float*>(dh);
  if (dtype == 0)
    return launch_dh<float>(h, w, lab, lse_f, glse_f, g_f, dh_f, dh_bf16, n, v, d, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(h, w, lab, lse_f, glse_f, g_f, dh_f, dh_bf16, n, v, d, s);
  return -1;
}

int fused_ce_bwd_dw(const void* h, const void* w, const void* labels, const void* lse,
                    const void* glse, const void* g, void* dw, int n, int v, int d, int dtype,
                    void* stream) {
  if (!shape_ok(n, v, d)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lse_f = static_cast<const float*>(lse);
  const float* glse_f = static_cast<const float*>(glse);
  const float* g_f = static_cast<const float*>(g);
  float* dw_f = static_cast<float*>(dw);
  if (dtype == 0) return launch_dw<float>(h, w, lab, lse_f, glse_f, g_f, dw_f, n, v, d, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(h, w, lab, lse_f, glse_f, g_f, dw_f, n, v, d, s);
  return -1;
}

const char* fused_ce_error_string(int code) {
  if (code == -1) return "unsupported dtype (float32 or bfloat16)";
  if (code == -2) return "unsupported shape (N >= 1, V >= 1, d a positive multiple of 32)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
