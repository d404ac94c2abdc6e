// Non-local attention forward for Hopper (sm_90a):
//   out[b, i, :] = softmax_j(scale * q[b, i, :] . k[b, j, :]) @ v[b, j, :]
//   lse[b, i]    = log(sum_j exp(scale * q[b, i, :] . k[b, j, :]))
//
// Replaces the TPU kernel `_attn_kernel` (pretorched_tpu/ops/pallas/
// nonlocal_attention.py:33, launched by `_nonlocal_attention_fwd_lse` at
// l.102). Same semantics: q (B, N, C), k (B, Nk, C), v (B, Nk, Cv), f32 or
// bf16 in, out (B, N, Cv) in q's type, lse (B, N) f32, f32 accumulation,
// padded keys masked with -1e30 (not -inf, so m_prev - m_cur never makes a
// NaN).
//
// What bounds it. At the slice's layer-2 shape (N = Nk = 6272, C = Cv = 256)
// one batch item is 2 * N^2 * (C + Cv) = 40 GFLOP against ~19 MB of q, k, v
// in bf16: about 2,000 FLOP per byte, so it is bound by the matrix units,
// not by memory.
//
// Design. The TPU kernel walks the key axis as a sequential grid dimension
// and carries the running max m, normalizer l and accumulator in VMEM
// scratch between grid steps. Blocks on a GPU run in no order, so here one
// block owns (batch item, 64-query tile) and loops over the 64-key tiles
// itself, keeping m and l in registers. C of any size is handled by forming
// q k^T in channel chunks. The ragged last key tile is masked; the ragged
// last query tile is zero-filled on load and skipped on store. Three
// kernels, chosen by the caller's dispatch on dtype and shape:
//
// * bf16 with C and Cv multiples of 64 up to 256 (the eval and train
//   layer-2 shapes, sub_sample): Hopper's own route, warp-specialised. One
//   producer thread streams k and v through a 2-slot TMA + mbarrier ring,
//   two consumer warpgroups run wgmma with the whole (64, Cv) accumulator
//   in registers, so q k^T is formed once and q is loaded once
//   (nonlocal_attention_fwd_wgmma_kernel below, wgmma_tiles.cuh).
// * other bf16 shapes (layer 3's C = Cv = 512, gaussian mode's C = 1024):
//   tensor cores through mma.sync.m16n8k16 with f32
//   accumulation, four warps of 16 query rows each (the FlashAttention-2
//   layout). The score tile stays in registers; P is rounded to bf16 for
//   P V, as in FlashAttention. The (16, Cv) accumulator of a warp would need
//   Cv / 2 registers a thread, so Cv is split over the grid in 128-column
//   chunks (grid.z) and each chunk recomputes q k^T: at C = Cv = 256 that is
//   1.5x the minimal FLOPs, bought for a register-resident accumulator.
//   Tiles are staged through shared memory with plain loads.
// * f32: scalar FMAs (TF32 would break the f32 tolerance), 16 x 16 threads,
//   each with a 4 x 4 register tile of scores; the (64, Cv) f32 accumulator
//   in dynamic shared memory (Cv <= 512: 185 KB with the staging tiles, of
//   the 227 KB a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ f32, scalar
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kCK = 32;        // channel chunk of q k^T
constexpr int kCV = 64;        // value-column chunk of p v
constexpr int kThreads = 256;  // 16 x 16

// Stride of a row of the shared accumulator: 16 floats past a multiple of
// 64, so the two row groups of one warp fall in different banks.
__host__ __device__ __forceinline__ int acc_stride(int cv) {
  return (cv + kCV - 1) / kCV * kCV + 16;
}

__global__ void __launch_bounds__(kThreads)
nonlocal_attention_fwd_f32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  float* __restrict__ out,
                                  float* __restrict__ lse, int n, int nk,
                                  int c, int cv, float scale) {
  extern __shared__ float smem[];
  const int os_stride = acc_stride(cv);
  const int cv_pad = os_stride - 16;
  float* qs = smem;                        // [kBQ][kCK + 1]
  float* ks = qs + kBQ * (kCK + 1);        // [kBK][kCK + 1]
  float* ps = ks + kBK * (kCK + 1);        // [kBQ][kBK + 1]
  float* vs = ps + kBQ * (kBK + 1);        // [kBK][kCV + 1]
  float* os = vs + kBK * (kCV + 1);        // [kBQ][os_stride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + (size_t)bi * n * c;
  const float* kb = k + (size_t)bi * nk * c;
  const float* vb = v + (size_t)bi * nk * cv;

  for (int e = tid; e < kBQ * os_stride; e += kThreads) os[e] = 0.f;
  float m_row[4], l_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += kBK) {
    // ---- s = q k^T for this key tile, 32 channels at a time
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kCK) {
      __syncthreads();  // earlier readers of qs, ks (and ps, vs) are done
      for (int e = tid; e < kBQ * kCK; e += kThreads) {
        const int r = e / kCK, cc = e % kCK;
        const int row = q0 + r, col = c0 + cc;
        qs[r * (kCK + 1) + cc] =
            (row < n && col < c) ? qb[(size_t)row * c + col] : 0.f;
      }
      for (int e = tid; e < kBK * kCK; e += kThreads) {
        const int r = e / kCK, cc = e % kCK;
        const int row = k0 + r, col = c0 + cc;
        ks[r * (kCK + 1) + cc] =
            (row < nk && col < c) ? kb[(size_t)row * c + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kCK; ++cc) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (kCK + 1) + cc];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * (kCK + 1) + cc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

    // ---- online softmax over this tile; the 16 threads of a row group
    // (same ty, tx = 0..15) are one half-warp
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = col < nk ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_row[i], mx);
      alpha[i] = expf(m_row[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_row[i] = l_row[i] * alpha[i] + sum;
      m_row[i] = m_new;
    }
    // ps is free: every thread passed a barrier after its last p v read
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = s[i][j];

    // ---- acc = alpha * acc + p v, 64 value columns at a time
    for (int v0 = 0; v0 < cv_pad; v0 += kCV) {
      __syncthreads();  // ps written; earlier readers of vs are done
      for (int e = tid; e < kBK * kCV; e += kThreads) {
        const int r = e / kCV, cc = e % kCV;
        const int row = k0 + r, col = v0 + cc;
        vs[r * (kCV + 1) + cc] =
            (row < nk && col < cv) ? vb[(size_t)row * cv + col] : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = os[(ty + 16 * i) * os_stride + v0 + tx + 16 * j] * alpha[i];
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float p[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = vs[kk * (kCV + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          os[(ty + 16 * i) * os_stride + v0 + tx + 16 * j] = acc[i][j];
    }
  }

  // ---- epilogue: each thread stores the accumulator elements it owns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float inv_l = 1.f / l_row[i];
    float* orow = out + ((size_t)bi * n + row) * cv;
    for (int col = tx; col < cv; col += 16)
      orow[col] = os[(ty + 16 * i) * os_stride + col] * inv_l;
    if (tx == 0) lse[(size_t)bi * n + row] = m_row[i] + logf(l_row[i]);
  }
}

size_t f32_smem_bytes(int cv) {
  return sizeof(float) * ((size_t)kBQ * (kCK + 1) + kBK * (kCK + 1) +
                          kBQ * (kBK + 1) + kBK * (kCV + 1) +
                          (size_t)kBQ * acc_stride(cv));
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int kMBQ = 64;
constexpr int kMBK = 64;
constexpr int kMCK = 64;        // channel chunk of q k^T
constexpr int kMDV = 128;       // value columns per block (grid.z)

__global__ void __launch_bounds__(kMThreads)
nonlocal_attention_fwd_bf16_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   bf16* __restrict__ out,
                                   float* __restrict__ lse, int n, int nk,
                                   int c, int cv, float scale) {
  __shared__ __align__(16) bf16 qs[kMBQ * kLd];
  __shared__ __align__(16) bf16 ks[kMBK * kLd];
  __shared__ __align__(16) bf16 vt[kMDV * kLd];   // V tile transposed

  const int tid = threadIdx.x;
  const int wr = (tid >> 5) * 16;       // the warp's first row in the tile
  const int lane = tid & 31;
  const int g = lane >> 2;              // fragment row (groupID)
  const int qd = lane & 3;              // fragment column pair
  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * kMBQ;
  const int v0 = blockIdx.z * kMDV;
  const bf16* qb = q + (size_t)bi * n * c;
  const bf16* kb = k + (size_t)bi * nk * c;
  const bf16* vb = v + (size_t)bi * nk * cv;
  const bool vec_qk = c % 8 == 0 && aligned16(q) && aligned16(k);
  const bool vec_v = cv % 8 == 0 && aligned16(v);

  // o[t][0..1]: row wr + g, cols v0 + 8t + 2qd + {0,1}; o[t][2..3]: row + 8
  float o[kMDV / 8][4];
#pragma unroll
  for (int t = 0; t < kMDV / 8; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < nk; k0 += kMBK) {
    // ---- s = q k^T (16 x 64 per warp), 64 channels at a time
    float s[kMBK / 8][4];
#pragma unroll
    for (int t = 0; t < kMBK / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kMCK) {
      __syncthreads();  // earlier readers of qs and ks are done
      load_rows<kMBQ>(qs, qb, c, q0, n, c0, c, vec_qk);
      load_rows<kMBK>(ks, kb, c, k0, nk, c0, c, vec_qk);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kMCK; kk += 16) {
        const bf16* qa = qs + (wr + g) * kLd + kk + 2 * qd;
        const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * kLd),
                               ld_pair(qa + 8), ld_pair(qa + 8 * kLd + 8)};
#pragma unroll
        for (int t = 0; t < kMBK / 8; ++t) {
          const bf16* kp = ks + (t * 8 + g) * kLd + kk + 2 * qd;
          mma_bf16(s[t], a, ld_pair(kp), ld_pair(kp + 8));
        }
      }
    }

    // ---- online softmax; a row's 64 scores sit in the 4 threads of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int t = 0; t < kMBK / 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + t * 8 + 2 * qd + e < nk;
        s[t][e] = valid ? s[t][e] * scale : kNegInf;
        s[t][2 + e] = valid ? s[t][2 + e] * scale : kNegInf;
        mx[0] = fmaxf(mx[0], s[t][e]);
        mx[1] = fmaxf(mx[1], s[t][2 + e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);
      alpha[h] = expf(m_i[h] - m_new);
      m_i[h] = m_new;
    }
#pragma unroll
    for (int t = 0; t < kMBK / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = expf(s[t][e] - m_i[e >> 1]);
        sum[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_i[h] = l_i[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int t = 0; t < kMDV / 8; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // ---- o += p v. vt is free: every warp passed this tile's first
    // barrier after its last read of it.
    load_rows_t<kMDV>(vt, vb, cv, k0, nk, v0, cv, vec_v);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMBK / 16; ++j) {
      // the C fragments of score tiles 2j, 2j+1 are the A fragment of P
      uint32_t a[4];
      c_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int t = 0; t < kMDV / 8; ++t) {
        const bf16* vp = vt + (t * 8 + g) * kLd + j * 16 + 2 * qd;
        mma_bf16(o[t], a, ld_pair(vp), ld_pair(vp + 8));
      }
    }
  }

  // ---- epilogue
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= n) continue;
    const float inv_l = 1.f / l_i[h];
    bf16* orow = out + ((size_t)bi * n + row) * cv;
#pragma unroll
    for (int t = 0; t < kMDV / 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + t * 8 + 2 * qd + e;
        if (col < cv) orow[col] = __float2bfloat16(o[t][2 * h + e] * inv_l);
      }
    if (blockIdx.z == 0 && qd == 0)
      lse[(size_t)bi * n + row] = m_i[h] + logf(l_i[h]);
  }
}

// ---------------------------------------- bf16, Hopper: wgmma, TMA, ring
// C and Cv multiples of 64, at most 256 (the dispatch in
// ops/cuda/nonlocal_attention.py). A block owns (batch item, 128 queries):
// warpgroups 0 and 1 consume 64 query rows each, warpgroup 2 produces
// (one thread issues every TMA copy). Shared memory, each tile a stack of
// swizzled 64-channel chunks (wgmma_tiles.cuh):
//   q      128 x C, loaded once              (256 C bytes)
//   k ring 2 slots of 64 keys x C            (256 C bytes)
//   v ring 2 slots of 64 keys x Cv           (256 Cv bytes; O's staging at
//                                             the end)
// 192 KB at C = Cv = 256. Per key tile a consumer forms S = q k^T (64 x 64,
// wgmma m64n64k16, both operands in shared memory), the online softmax in
// registers (a row across the 4 threads of a quad), P in bf16 straight from
// the accumulator, then O += P v (wgmma with A = P from registers, B = v
// MN-major: m64n256k16 at Cv = 256, Cv / 64 m64n64k16 otherwise). O (64 x
// Cv f32) stays in 128 registers a thread: no Cv split, no recompute.
constexpr int kWQ = 128;            // query rows per block
constexpr int kWK = 64;             // keys per tile

size_t fwd_wgmma_smem(int c, int cv) {
  return 512 * (size_t)c + 256 * (size_t)cv + 2 * sizeof(Ring<2>) +
         sizeof(uint64_t) + 1024;   // + 1024: aligning the base
}

__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __grid_constant__ CUtensorMap omap,
                                    float* __restrict__ lse, int n, int nk,
                                    int c, int cv, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + 256 * c;
  unsigned char* vs = ks + 256 * c;
  Ring<2>* kring = reinterpret_cast<Ring<2>*>(vs + 256 * cv);
  Ring<2>* vring = kring + 1;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vring + 1);

  const int nc = c / 64, nv = cv / 64;
  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * kWQ;
  const int tiles = (nk + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    kring->init(kWConsumerWarps);
    vring->init(kWConsumerWarps);
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: q once, then k and v tiles through the rings
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, kWQ * c * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(qs + j * kWQ * 128, &qmap, qbar, 64 * j, q0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<2>::slot(t);
        kring->wait_empty(t);
        mbar_expect_tx(&kring->full[s], kWK * c * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(ks + s * 128 * c + j * 8192, &kmap, &kring->full[s],
                   64 * j, t * kWK, bi);
        vring->wait_empty(t);
        mbar_expect_tx(&vring->full[s], kWK * cv * 2);
        for (int j = 0; j < nv; ++j)
          tma_load(vs + s * 128 * cv + j * 8192, &vmap, &vring->full[s],
                   64 * j, t * kWK, bi);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const float sl2 = scale * kLog2e;   // scores in log2 units
    const uint32_t q_rows = smem_addr(qs) + wg * 64 * 128;

    float o[4][32];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf};
    float l_i[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = Ring<2>::slot(t);
      // ---- S = q k^T
      float sc[32];
      kring->wait_full(t);
      wgmma_fence();
      ss_scores(sc, q_rows, kWQ * 128, smem_addr(ks) + s * 128 * c, nc);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      kring->release(t);

      // ---- online softmax; keys past nk (zero-filled) are masked
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t * kWK + 8 * (i >> 2) + 2 * qd + (i & 1);
        sc[i] = key < nk ? sc[i] * sl2 : kNegInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_i[h], mx[h]);
        alpha[h] = exp2f(m_i[h] - m_new);
        m_i[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(sc[i] - m_i[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_i[h] = l_i[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_to_a(pa[j], sc, j);

      // ---- O += P v
      vring->wait_full(t);
      const uint32_t vt = smem_addr(vs) + s * 128 * cv;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rs_product(o, pa[kk], vt + kk * 16 * 128, nv);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        reg_fence(o[j]);
        reg_fence(pa[j]);
      }
      vring->release(t);
    }

    // ---- epilogue: O / l in bf16 through the v ring (free once both
    // consumer warpgroups are past their last product), one TMA store per
    // 64-column chunk of this warpgroup's rows; lse in f32
    named_sync(1, 256);
    float inv_l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv_l[h] = 1.f / l_i[h];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nv) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const int r = wg * 64 + warp * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(
            vs + j * kWQ * 128 + swizzled_pair(r, 8 * (i >> 2) + 2 * qd)) =
            pack_pair(o[j][i] * inv_l[h], o[j][i + 1] * inv_l[h]);
      }
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (tid == 0) {
      for (int j = 0; j < nv; ++j)
        tma_store(&omap, vs + j * kWQ * 128 + wg * 64 * 128, 64 * j,
                  q0 + wg * 64, bi);
      tma_store_drain();
    }
    if (qd == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + wg * 64 + warp * 16 + g + 8 * h;
        if (row < n)
          lse[(size_t)bi * n + row] = (m_i[h] + log2f(l_i[h])) * kLn2;
      }
    }
  }
}

int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int b, int n, int nk, int c, int cv,
                     float scale, cudaStream_t stream) {
  if (c % 64 || cv % 64 || c > 256 || cv > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, b, n, c, kWQ) || !make_map(&km, k, b, nk, c, kWK) ||
      !make_map(&vm, v, b, nk, cv, kWK) || !make_map(&om, out, b, n, cv, 64))
    return (int)cudaErrorNotSupported;
  const size_t smem = fwd_wgmma_smem(c, cv);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem(nonlocal_attention_fwd_wgmma_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kWQ - 1) / kWQ, b);
  nonlocal_attention_fwd_wgmma_kernel<<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, om, lse, n, nk, c, cv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (mma.sync). All
// tensors contiguous, on the current device. Returns the cudaError_t of the
// launch (0 = cudaSuccess).
int pt_nonlocal_attention_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int b, int n, int nk,
                              int c, int cv, float scale, int dtype,
                              void* stream) {
  if (b < 1 || n < 1 || nk < 1 || c < 1 || cv < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(cv);
    cudaError_t err = cudaFuncSetAttribute(
        nonlocal_attention_fwd_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + kBQ - 1) / kBQ, b);
    nonlocal_attention_fwd_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), l, n, nk, c,
        cv, scale);
  } else if (dtype == 1) {
    const dim3 grid((n + kMBQ - 1) / kMBQ, b, (cv + kMDV - 1) / kMDV);
    nonlocal_attention_fwd_bf16_kernel<<<grid, kMThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), l, n, nk, c,
        cv, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The bf16 wgmma kernel: the same function as pt_nonlocal_attention_fwd,
// for C and Cv multiples of 64 up to 256 and 16-byte aligned tensors (the
// caller's dispatch picks it).
int pt_nonlocal_attention_fwd_wgmma(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int b, int n, int nk, int c, int cv,
                                    float scale, void* stream) {
  if (b < 1 || n < 1 || nk < 1 || c < 1 || cv < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_wgmma(q, k, v, out, static_cast<float*>(lse), b, n, nk,
                          c, cv, scale, static_cast<cudaStream_t>(stream));
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
