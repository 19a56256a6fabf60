// The fused lm-head CE's bf16 dW with its f32 accumulator in shared memory,
// for timing against csrc/fused_ce.cu's design only (the port never calls
// it; tools/fused_ce_dw_variants.py builds and times it). One block of
// eight warps per 64 vocab rows holds dW for those rows (up to d = 768,
// rows padded by 8 floats) in shared memory and walks the tokens in tiles
// of 64: the logits of a tile over d on the tensor cores (W and h chunks
// through a two-stage cp.async ring), dlogit in f32 split into bf16 hi
// and lo kept in registers as A fragments, then dW += dlogit^T h per
// 128 columns, each warp's partial added into shared memory in a fixed
// order (warps of the first 32 tokens, a barrier, then the others).
// Takes d a multiple of 128 up to 768.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "tile_mma.cuh"

namespace {
using tile_mma::bf16;
constexpr int kThreads = 256;
constexpr int kRows = 64, kT = 64, kDChunk = 64, kOutCols = 128, kStages = 2;
constexpr int kMaxD = 768, kAccLd = kMaxD + 8;
constexpr int kStageElems = kRows * kDChunk + kT * kDChunk;
constexpr size_t kSmem = sizeof(float) * kRows * kAccLd + sizeof(bf16) * kStages * kStageElems +
                         16 * kT;

__device__ __forceinline__ float dlogit(float logit, float lse, float glse, float g, bool hit) {
  return expf(logit - lse) * glse - (hit ? g : 0.0f);
}

__global__ void __launch_bounds__(kThreads, 1)
dw_b(const bf16* __restrict__ h, const bf16* __restrict__ w, const int* __restrict__ labels,
     const float* __restrict__ lse, const float* __restrict__ glse, const float* __restrict__ g,
     float* __restrict__ dw, int n, int v, int d) {
  using namespace tile_mma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_acc = reinterpret_cast<float*>(smem_raw);
  bf16* s_ring = reinterpret_cast<bf16*>(s_acc + kRows * kAccLd);
  float* s_lse = reinterpret_cast<float*>(s_ring + kStages * kStageElems);
  float* s_glse = s_lse + kT;
  float* s_g = s_glse + kT;
  int* s_lab = reinterpret_cast<int*>(s_g + kT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t v0 = (int64_t)blockIdx.x * kRows;
  const int n_dc = (d + kDChunk - 1) / kDChunk, n_oc = (d + kOutCols - 1) / kOutCols;
  const int n_tiles = (n + kT - 1) / kT;
  for (int i = tid; i < kRows * kAccLd; i += kThreads) s_acc[i] = 0.0f;

  const int lr = tid >> 3, lc = tid & 7, pr = tid >> 4, pc = tid & 15;
  int ld_tile = 0, ld_phase = 0, ld_b = 0, ld_slot = 0;
  auto issue_next = [&]() {
    if (ld_tile < n_tiles) {
      bf16* dst = s_ring + ld_slot * kStageElems;
      const int64_t t0 = (int64_t)ld_tile * kT;
      if (ld_phase == 0) {
        const int col = ld_b * kDChunk + 8 * lc;
        for (int j = 0; j < 2; ++j) {
          const int r = lr + 32 * j;
          const int64_t row = v0 + r;
          const bool ok = col < d && row < v;
          cp_async_16(smem_addr(dst + swizzle<kDChunk>(r, lc)), ok ? w + row * d + col : w, ok);
          const int64_t trow = t0 + r;
          const bool tok = col < d && trow < n;
          cp_async_16(smem_addr(dst + kRows * kDChunk + swizzle<kDChunk>(r, lc)),
                      tok ? h + trow * d + col : h, tok);
        }
        if (++ld_b == n_dc) ld_b = 0, ld_phase = 1;
      } else {
        const int col = ld_b * kOutCols + 8 * pc;
        for (int j = 0; j < 4; ++j) {
          const int r = pr + 16 * j;
          const int64_t row = t0 + r;
          const bool ok = col < d && row < n;
          cp_async_16(smem_addr(dst + swizzle<kOutCols>(r, pc)), ok ? h + row * d + col : h, ok);
        }
        if (++ld_b == n_oc) ld_b = 0, ld_phase = 0, ++ld_tile;
      }
      ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
    }
    cp_async_commit();
  };
  int slot = 0;
  auto advance = [&]() -> const bf16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue_next();
    const bf16* st = s_ring + slot * kStageElems;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    return st;
  };
  for (int i = 0; i < kStages - 1; ++i) issue_next();

  const int wv = warp & 3, wt = warp >> 2;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int64_t t0 = (int64_t)tile * kT;
    if (tid < kT) {
      const int64_t t = t0 + tid;
      const bool ok = t < n;
      s_lse[tid] = ok ? lse[t] : 0.0f;
      s_glse[tid] = ok ? glse[t] : 0.0f;
      s_g[tid] = ok ? g[t] : 0.0f;
      s_lab[tid] = ok ? labels[t] : -1;
    }
    float logit[4][4];
    for (int dc = 0; dc < n_dc; ++dc) {
      const bf16* w_s = advance();
      const bf16* h_s = w_s + kRows * kDChunk;
      float part[4][4];
      for (int nt = 0; nt < 4; ++nt)
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        load_a<kDChunk>(a, w_s, 16 * wv, ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          load_b_rows<kDChunk>(b, h_s, 32 * wt + 16 * np, ks);
          mma(part[2 * np], a, b[0], b[1]);
          mma(part[2 * np + 1], a, b[2], b[3]);
        }
      }
      for (int nt = 0; nt < 4; ++nt)
        for (int e = 0; e < 4; ++e) logit[nt][e] = dc == 0 ? part[nt][e] : logit[nt][e] + part[nt][e];
    }
    float hi[4][4], lo[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t vocab = v0 + 16 * wv + gq + 8 * (e >> 1);
        const int ts = 32 * wt + 8 * nt + 2 * tq + (e & 1);
        const float x = (vocab < v && t0 + ts < n)
                            ? dlogit(logit[nt][e], s_lse[ts], s_glse[ts], s_g[ts], vocab == s_lab[ts])
                            : 0.0f;
        hi[nt][e] = __bfloat162float(__float2bfloat16(x));
        lo[nt][e] = x - hi[nt][e];
      }
    uint32_t ah[2][4], al[2][4];
    for (int kk = 0; kk < 2; ++kk) {
      c_to_a(ah[kk], hi[2 * kk], hi[2 * kk + 1]);
      c_to_a(al[kk], lo[2 * kk], lo[2 * kk + 1]);
    }
    for (int oc = 0; oc < n_oc; ++oc) {
      const bf16* h_s = advance();
      float acc[16][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int dp = 0; dp < 8; ++dp) {
          uint32_t b[4];
          load_b_cols<kOutCols>(b, h_s, 32 * wt + 16 * kk, dp);
          mma(acc[2 * dp], ah[kk], b[0], b[1]);
          mma(acc[2 * dp + 1], ah[kk], b[2], b[3]);
          mma(acc[2 * dp], al[kk], b[0], b[1]);
          mma(acc[2 * dp + 1], al[kk], b[2], b[3]);
        }
      for (int turn = 0; turn < 2; ++turn) {
        if (wt == turn) {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int col = oc * kOutCols + 8 * nt + 2 * tq;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* p = reinterpret_cast<float2*>(s_acc + (16 * wv + gq + 8 * half) * kAccLd + col);
              float2 o = *p;
              o.x += acc[nt][2 * half];
              o.y += acc[nt][2 * half + 1];
              *p = o;
            }
          }
        }
        if (turn == 0) __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (v0 + r < v) dw[(v0 + r) * d + c] = s_acc[r * kAccLd + c];
  }
}
}  // namespace

extern "C" int dw_option_b(const void* h, const void* w, const void* labels, const void* lse,
                           const void* glse, const void* g, void* dw, int n, int v, int d,
                           void* stream) {
  if (d > kMaxD || d % 128) return -2;
  cudaError_t err = cudaFuncSetAttribute(dw_b, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  dw_b<<<(v + kRows - 1) / kRows, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(glse), static_cast<const float*>(g),
      static_cast<float*>(dw), n, v, d);
  return (int)cudaGetLastError();
}
