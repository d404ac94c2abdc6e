// Tile helpers shared by the bf16 tensor-core kernels of the non-local
// attention (forward and backward): mma.sync.m16n8k16 with f32
// accumulation, fragment packing, ldmatrix, and the staging of tiles into
// shared memory: by plain loads, straight or transposed, for a block of
// kMThreads threads (4 warps of 16 rows each; the forward), or by cp.async
// for a block of any size (the backward).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, qd = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2qd..+1), a1 = (g + 8, 2qd..+1),
//                           a2 = (g, 2qd+8..+9), a3 = (g + 8, 2qd+8..+9)
//   B (16 x 8, "col"):      b0 = (k 2qd..+1, n g), b1 = (k 2qd+8..+9, n g)
//   C (16 x 8):             c0, c1 = (g, 2qd..+1), c2, c3 = (g + 8, 2qd..+1)
// so the C fragments of two adjacent 8-column tiles are the A fragment of
// the next product, and a B operand is a 32-bit load when its k index runs
// along a row of shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMThreads = 128;  // 4 warps x 16 rows
constexpr int kLd = 72;         // smem row stride in bf16: 64 + 8 pad, so
                                // fragment loads of 8 rows hit 32 banks

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment for k-step j (16 columns) from the C fragments of the
// 8-column tiles 2j and 2j + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_pair(lo[0], lo[1]);
  a[1] = pack_pair(lo[2], lo[3]);
  a[2] = pack_pair(hi[0], hi[1]);
  a[3] = pack_pair(hi[2], hi[3]);
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// 8 consecutive elements src[row][col..col+7], zero past rows or cols.
__device__ __forceinline__ void load8(Pack8& p, const bf16* src, int ld,
                                      int row, int rows, int col, int cols,
                                      bool vec) {
  if (vec && row < rows && col + 8 <= cols) {
    p.u = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + col);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p.h[e] = (row < rows && col + e < cols) ? src[(size_t)row * ld + col + e]
                                              : __float2bfloat16(0.f);
  }
}

// dst[r][cc] = src[row0 + r][col0 + cc] for r < ROWS, cc < 64; zero where
// row >= rows or col >= cols. 8 threads cover one 64-element row. `vec`
// (16-byte loads) needs ld % 8 == 0 and a 16-byte aligned src.
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int ld,
                                          int row0, int rows, int col0,
                                          int cols, bool vec) {
  for (int gi = threadIdx.x; gi < ROWS * 8; gi += kMThreads) {
    const int r = gi >> 3, cc = (gi & 7) * 8;
    Pack8 p;
    load8(p, src, ld, row0 + r, rows, col0 + cc, cols, vec);
    *reinterpret_cast<uint4*>(dst + r * kLd + cc) = p.u;
  }
}

// The transpose: dst[cc][r] = src[row0 + r][col0 + cc] for r < 64,
// cc < COLS, zero-filled the same way. Consecutive threads take consecutive
// rows r, so the transposing stores of a warp do not collide in one bank.
template <int COLS>
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src, int ld,
                                            int row0, int rows, int col0,
                                            int cols, bool vec) {
  for (int gi = threadIdx.x; gi < 64 * (COLS / 8); gi += kMThreads) {
    const int r = gi % 64, cc = (gi / 64) * 8;
    Pack8 p;
    load8(p, src, ld, row0 + r, rows, col0 + cc, cols, vec);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(cc + e) * kLd + r] = p.h[e];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] holds each lane's pair of it, in the
// fragment layout above (row lane / 4, columns 2 (lane % 4) and + 1). With
// .trans each matrix is transposed on the way: row 2 (lane % 4) and + 1,
// column lane / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without passing through registers; with
// valid == false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// dst[r][cc] = src[row0 + r][col0 + cc] for r < ROWS, cc < COLS (a multiple
// of 8), dst rows ldd apart, by the block's NT threads; zero where
// row >= rows or col >= cols. Whole 16-byte groups, in range or wholly out
// of it, go by cp.async (the caller commits and waits); a group cut by
// `cols`, and every group when !vec, by plain loads and stores.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, int ldd,
                                                const bf16* src, int ld,
                                                int row0, int rows, int col0,
                                                int cols, bool vec) {
  constexpr int kGroups = COLS / 8;
  for (int gi = threadIdx.x; gi < ROWS * kGroups; gi += NT) {
    const int r = gi / kGroups, cc = (gi % kGroups) * 8;
    const int row = row0 + r, col = col0 + cc;
    bf16* d = dst + r * ldd + cc;
    const bool full = row < rows && col + 8 <= cols;
    if (vec && (full || row >= rows || col >= cols)) {
      cp_async16(d, full ? src + (size_t)row * ld + col : src, full);
    } else {
      Pack8 p;
      load8(p, src, ld, row, rows, col, cols, false);
      *reinterpret_cast<uint4*>(d) = p.u;
    }
  }
}

}  // namespace
