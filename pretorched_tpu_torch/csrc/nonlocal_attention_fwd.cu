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
// last query tile is zero-filled on load and skipped on store. Two paths,
// chosen by dtype:
//
// * bf16 (the model's path): tensor cores through mma.sync.m16n8k16 with f32
//   accumulation, four warps of 16 query rows each (the FlashAttention-2
//   layout). The score tile stays in registers; P is rounded to bf16 for
//   P V, as in FlashAttention. The (16, Cv) accumulator of a warp would need
//   Cv / 2 registers a thread, so Cv is split over the grid in 128-column
//   chunks (grid.z) and each chunk recomputes q k^T: at C = Cv = 256 that is
//   1.5x the minimal FLOPs, bought for a register-resident accumulator.
//   Tiles are staged through shared memory with plain loads; no cp.async,
//   TMA or wgmma yet (later work).
// * f32: scalar FMAs (TF32 would break the f32 tolerance), 16 x 16 threads,
//   each with a 4 x 4 register tile of scores; the (64, Cv) f32 accumulator
//   in dynamic shared memory (Cv <= 512: 185 KB with the staging tiles, of
//   the 227 KB a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, on the current
// device. Returns the cudaError_t of the launch (0 = cudaSuccess).
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

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
