// Tensor-core building blocks shared by the hand-written kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu, fused_ce.cu): cp.async
// copies into swizzled bf16 tiles in shared memory, ldmatrix fragment
// loads and the m16n8k16 bf16 MMA with f32 accumulators.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                           a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, f32)         c0 c1 (g, 2t..2t+1)    c2 c3 (g+8, 2t..2t+1)
// The C fragments of two neighbouring n8 tiles are, once packed to bf16,
// exactly the A fragment of a k16 step: a product's f32 result feeds the
// next product from registers.
//
// Tiles are (rows, D) bf16 with D a multiple of 64 (64 and 128 for the
// attention head dims, 512 for the fused CE's dlogit tile): each row is
// D / 8 chunks of 16 bytes, and chunk c of row r lives at chunk c ^ (r & 7),
// so the eight 16-byte rows that one ldmatrix phase reads fall in eight
// distinct bank groups (no conflicts, with or without .trans).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_mma {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;
constexpr int kThreads = 128;  // four warps

// Offset, in elements, of chunk `chunk` (8 elements) of row `row`.
template <int D>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (or 4-byte) asynchronous copy; `full` false writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of the most recent groups are in flight
// (0: every copy issued so far has landed).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [p0, p0 + 64) of a (.., T, heads, D) tensor (`base` at row 0 of
// this batch and head) into a swizzled (64, D) tile; rows at or past
// `seq_len` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int64_t row_stride, int p0,
                                          int seq_len) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int p = p0 + r;
    const bool live = p < seq_len;
    cp_async_16(smem_addr(dst + swizzle<D>(r, c)),
                base + (int64_t)(live ? p : 0) * row_stride + c * 8, live);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment of rows [row0, row0 + 16) x columns [16 ks, 16 ks + 16) of
// a row-major swizzled tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int ks) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_addr(tile + swizzle<D>(row0 + (lane & 15), ks * 2 + (lane >> 4))));
}

// B fragments of two n8 tiles whose n runs along the tile's rows
// [row0, row0 + 16) and k along its columns [16 ks, 16 ks + 16) (the tile
// holds B transposed, as K does for S = Q K^T): b[0], b[1] for rows
// row0..row0+7, b[2], b[3] for rows row0+8..row0+15.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int row0, int ks) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, smem_addr(tile + swizzle<D>(row0 + (lane & 7) + ((lane >> 4) << 3),
                                             ks * 2 + ((lane >> 3) & 1))));
}

// B fragments of two n8 tiles whose k runs along the tile's rows
// [row0, row0 + 16) and n along its columns [16 dp, 16 dp + 16) (V in
// O = P V): b[0], b[1] for columns 16dp..16dp+7, b[2], b[3] for the next 8.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile, int row0, int dp) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, smem_addr(tile + swizzle<D>(row0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                   dp * 2 + (lane >> 4))));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the k16 step made of C tiles c[2kk] and c[2kk + 1].
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A warp's (16, D) f32 C tiles, times `mul`, into rows [row0, row0 + 16)
// of a swizzled bf16 tile, then from there to rows [p0 + row0, ..) of the
// (.., T, heads, D) output in 16-byte stores; rows at or past `seq_len`
// are not written. Only the calling warp touches those rows.
template <int D>
__device__ __forceinline__ void store_rows(bf16* stage, const float (&c)[D / 8][4], float mul0,
                                           float mul1, int row0, bf16* out, int64_t row_stride,
                                           int p0, int seq_len) {
  constexpr int kChunks = D / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < kChunks; ++dt) {
    *reinterpret_cast<uint32_t*>(stage + swizzle<D>(row0 + g, dt) + 2 * t) =
        pack_bf16(c[dt][0] * mul0, c[dt][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + swizzle<D>(row0 + g + 8, dt) + 2 * t) =
        pack_bf16(c[dt][2] * mul1, c[dt][3] * mul1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, ch = i % kChunks;
    const int p = p0 + row0 + r;
    if (p < seq_len)
      *reinterpret_cast<uint4*>(out + (int64_t)p * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + swizzle<D>(row0 + r, ch));
  }
}

}  // namespace tile_mma
