// What the f32 programs on TF32 wgmma (tf32_wgmma: the f32 K1-fwd in
// nonlocal_attention_fwd.cu, K1-dq and K1-dkv in nonlocal_attention_bwd.cu)
// share: their pre-pass and their score stage.
//
// TF32 wgmma reads both operands from shared memory K-major only, and an
// operand split once into its TF32 halves, hi = tf32(x) and lo = tf32(x -
// hi), spares every block the split. So each program's wrapper hands it
// scratch, and tf32_split_kernel writes into it each f32 operand's halves,
// as stored and / or transposed: one tensor (2b, rows, cols) per operand,
// hi of item i at 2i, lo at 2i + 1, so that one TMA map serves both
// halves. A score stage (tw_stage) takes one 32 KB ring slot: the 64 rows'
// and the 64 columns' 32-channel chunks, each as its two halves.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kGSlot = 32768;   // a ring slot: 4 boxes of 64 x 32 f32

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Queue ring stage st's chunk product into p (the consumer's 64 x 32 of s
// or dp from zero): A the rows' chunk, B the consumer's 32 columns of the
// columns' chunk (b_off), both as TF32 halves in the slot.
template <int ST>
__device__ __forceinline__ void tw_stage(float (&p)[16], Ring<ST>* ring,
                                         uint32_t ring_s, int st,
                                         uint32_t b_off) {
  ring->wait_full(st);
  const uint32_t sl = ring_s + Ring<ST>::slot(st) * kGSlot;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32x3(p, sl + 32 * kk, sl + 8192 + 32 * kk,
                 sl + 16384 + b_off + 32 * kk, sl + 24576 + b_off + 32 * kk,
                 kk == 0);
  wgmma_commit();
}

// x (b, rows, cols) f32 -> its TF32 halves sp (2b, rows, cols_p), hi of
// item i at 2i, lo at 2i + 1, zero past cols, where sp is given; and,
// where spt is given, the same transposed, spt (2b, cols_p, rows_p), zero
// past rows. Tiles of 32 x 32 through shared memory, every load and store
// coalesced.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float* __restrict__ sp,
                  float* __restrict__ spt, int rows, int cols, int cols_p,
                  int rows_p) {
  __shared__ float hs[32][33], ls[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int bi = blockIdx.z;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const float* xb = x + (size_t)bi * rows * cols;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    const float v = r < rows && c < cols ? xb[(size_t)r * cols + c] : 0.f;
    uint32_t h, l;
    split_tf32(v, h, l);
    if (sp != nullptr && r < rows) {
      float* hi = sp + (size_t)(2 * bi) * rows * cols_p;
      hi[(size_t)r * cols_p + c] = __uint_as_float(h);
      hi[(size_t)(rows + r) * cols_p + c] = __uint_as_float(l);
    }
    hs[i][tx] = __uint_as_float(h);
    ls[i][tx] = __uint_as_float(l);
  }
  if (spt == nullptr) return;
  __syncthreads();
  float* hit = spt + (size_t)(2 * bi) * cols_p * rows_p;
  float* lot = hit + (size_t)cols_p * rows_p;
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (r < rows_p) {
      hit[(size_t)c * rows_p + r] = hs[tx][i];
      lot[(size_t)c * rows_p + r] = ls[tx][i];
    }
  }
}

// Bytes of one split operand (2b, rows, cols) f32, 256-byte aligned.
size_t tw_region(int b, int rows, int cols) {
  return ((size_t)2 * b * rows * cols * sizeof(float) + 255) / 256 * 256;
}

// Split x (b, rows, cols) into sp and / or spt (either may be null) with
// cols_p a multiple of 32; spt's rows (the streamed axis) padded to 4, so
// that its rows are whole 16-byte TMA strides.
int launch_split(const float* x, float* sp, float* spt, int b, int rows,
                 int cols, int cols_p, cudaStream_t stream) {
  const int rows_p = spt ? round_up(rows, 4) : rows;
  const dim3 grid(cols_p / 32, (rows_p + 31) / 32, b);
  tf32_split_kernel<<<grid, 256, 0, stream>>>(x, sp, spt, rows, cols, cols_p,
                                              rows_p);
  return (int)cudaGetLastError();
}

}  // namespace
