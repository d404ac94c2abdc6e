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
// not by memory. In f32 (B = 8) that is 322 GFLOP: 1.95 ms at the tensor
// cores' TF32 rate over 3 (tf32x3 below), 4.81 ms on the CUDA cores.
//
// Design. The TPU kernel walks the key axis as a sequential grid dimension
// and carries the running max m, normalizer l and accumulator in VMEM
// scratch between grid steps. Blocks on a GPU run in no order, so here one
// block owns (batch item, 64-query tile) and loops over the 64-key tiles
// itself, keeping m and l in registers. C of any size is handled by forming
// q k^T in channel chunks. The ragged last key tile is masked; the ragged
// last query tile is zero-filled on load and skipped on store. Six
// kernels, chosen by the caller's dispatch on dtype and shape:
//
// * bf16 with C and Cv multiples of 8 up to 256 (the eval and train
//   layer-2 shapes, sub_sample; SAGAN's C = 48, Cv = 192 in biggan128;
//   MNISTNonLocalNet's 16 and 32): Hopper's own route, warp-specialised. One
//   producer thread streams k and v through a 2-slot TMA + mbarrier ring,
//   two consumer warpgroups run wgmma with the whole (64, Cv) accumulator
//   in registers, so q k^T is formed once and q is loaded once
//   (nonlocal_attention_fwd_wgmma_kernel below, wgmma_tiles.cuh).
// * bf16 with C and Cv multiples of 8 up to 512, one above 256 (layer 3's
//   C = Cv = 512; SAGAN's C = 96, Cv = 384 in biggan256): the wide wgmma
//   kernel. A 64 x 512 f32 O does not fit a
//   warpgroup's registers, so the two consumer warpgroups share 64 query
//   rows and each owns half of O's columns; both form the same q k^T
//   (nonlocal_attention_fwd_wide_kernel below).
//   Both wgmma kernels read whole 64-channel TMA boxes. A width that is no
//   multiple of 64 is padded to the next one, Cp = ceil(C / 64) 64 and Cvp
//   = ceil(Cv / 64) 64, by TMA itself: a box reads zeros past the tensor's
//   last column (the map's OOB fill), so no copy is made and no extra byte
//   comes from memory. Zero channels add nothing to q k^T, and O's columns
//   past Cv are clipped by the TMA store. The kernels take the padded
//   widths; only the tensor maps know C and Cv. The cost is the products
//   on zero channels: 1.07x the minimal at C = 48, Cv = 192 and at C = 96,
//   Cv = 384. TMA needs 16-byte rows, so C and Cv are multiples of 8.
// * other bf16 shapes (gaussian mode's C = 1024, channels that are no
//   multiple of 8): tensor cores through mma.sync.m16n8k16 with f32
//   accumulation, four warps of 16 query rows each (the FlashAttention-2
//   layout). The score tile stays in registers; P is rounded to bf16 for
//   P V, as in FlashAttention. The (16, Cv) accumulator of a warp would need
//   Cv / 2 registers a thread, so Cv is split over the grid in 128-column
//   chunks (grid.z) and each chunk recomputes q k^T: at C = Cv = 256 that is
//   1.5x the minimal FLOPs, bought for a register-resident accumulator.
//   Tiles are staged through shared memory with plain loads.
// * f32 with C and Cv up to 512 (every f32 forward of the models: layers 2
//   and 3, SAGAN's 48 / 192 and 96 / 384, the golden lock's 16 / 64,
//   MNIST's 16 and 32): tf32_wgmma, the arithmetic of tf32x3 below on
//   Hopper's TF32 wgmma with TMA, warp-specialised
//   (nonlocal_attention_fwd_tf32_wgmma_kernel near the end of this file,
//   its pre-pass tf32_split_kernel in tf32_wgmma.cuh). TF32 wgmma reads
//   both operands K-major only, so a pre-pass splits q and k once into
//   their TF32 halves and v into its halves transposed, in scratch, and
//   pads every width to 32 with zeros (widths that TMA cannot take, such
//   as C = 7, never reach the main kernel); P goes through shared memory,
//   split, and O = alpha O + the tile's P v partial in f32. At layer 2
//   3.4 ms against tf32x3's 10.0 (PERF.md). tf32x3 stays launchable by
//   name (the A/B against it).
// * f32 by name (the program tf32_wgmma replaced): tf32x3,
//   mma.sync.m16n8k8 in TF32 with three products per f32 product
//   (nonlocal_attention_fwd_tf32x3_kernel), as the f32 backward
//   (nonlocal_attention_bwd.cu, mma_tiles.cuh): each operand split in
//   registers into hi = tf32(x) and lo = tf32(x - hi), lo hi + hi lo + hi
//   hi, the small terms first. One TF32 product alone keeps 11 bits and
//   misses the f32 tolerance (out 2e-4 at logits of a few units); three
//   keep about 22. The mma's own sums truncate, so each 64-channel chunk of
//   s and each stage of P v is summed from zero on the tensor cores and
//   joins s or O by an f32 add, which rounds to nearest. A block of 8 warps
//   owns 64 query rows (4 warp rows x 2 halves) and the whole width of O
//   in registers (64 f32 a thread at Cv = 256, 128 at 512), so s is formed
//   once per 64-key tile, each warp a 16 x 32 piece of it; the two warps
//   of a row exchange their row maxima through shared memory (one barrier a
//   tile), write p split into its TF32 halves to shared memory, and each
//   multiplies P (16 x 64) by its half of v's columns after scaling its
//   half of O by the tile's alpha. The q and k chunks and the rows of v
//   stream through a 3-slot cp.async ring of 36 KB slots (144 KB a block,
//   one block an SM; 194 registers a thread at Cv = 256, 233 at 512, no
//   spills). Widths off 64 read zeros past C and Cv
//   (cp.async's zero fill); the columns of O past Cv are not stored.
// * f32 otherwise (C or Cv above 512: gaussian mode's C = 1024): scalar
//   FMAs, 16 x 16 threads, each with a 4 x 4 register tile of scores; the
//   (64, Cv) f32 accumulator in dynamic shared memory (Cv <= 512: 185 KB
//   with the staging tiles, of the 227 KB a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tf32_wgmma.cuh"
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

// ------------------------------------------- f32, tensor cores: tf32x3
constexpr int kXRows = 64;          // query rows a block: 4 warp rows of 16
constexpr int kXKeys = 64;          // keys a tile
constexpr int kXK = 64;             // channel chunk of s
constexpr int kXLdK = kXK + 8;      // 8 mod 32: the 8-byte fragment loads of
constexpr int kXLdP = kXKeys + 8;   // 8 rows x 4 lanes hit 32 banks
constexpr int kXThreads = 256;      // 8 warps: 4 warp rows x 2 halves
constexpr int kXStages = 3;         // ring slots: one in use, two loading
constexpr int kXSlot = (kXRows + kXKeys) * kXLdK;   // floats: q and k chunks
constexpr size_t kXSmem =
    (kXStages * kXSlot + 2 * kXRows * kXLdP + 2 * kXRows) * sizeof(float);
constexpr int kXMaxWidth = 512;     // the widest C, Cv the C entry takes

// Rows of v a ring slot takes at NT 8-column tiles a warp: its rows are 16
// NT + 4 floats (4 mod 32: the B fragments' 4-byte loads of rows 2qd and
// 2qd + 1, columns g, hit 32 banks).
__host__ __device__ constexpr int tf32x3_v_rows(int nt) {
  return 64 * (16 * nt + 4) <= kXSlot   ? 64
         : 32 * (16 * nt + 4) <= kXSlot ? 32
         : 16 * (16 * nt + 4) <= kXSlot ? 16
                                        : 8;
}

// s[t] += the warp's 16 x 32 tile (query rows wr.., keys 32 half + 8t..) of
// q k^T over one kXK-channel chunk: the block's q rows and the tile's k rows
// kXLdK apart in `slot`. The chunk's sum starts from zero on the tensor
// cores and joins s by an f32 add (see mma_tf32x3).
__device__ __forceinline__ void tf32x3_s_chunk(float (&s)[4][4],
                                               const float* slot, int wr,
                                               int half) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const float* a = slot + (wr + g) * kXLdK + 2 * qd;
  const float* b = slot + (kXRows + 32 * half + g) * kXLdK + 2 * qd;
  float partial[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kXK; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * kXLdK + kk);
    uint32_t ahi[4], alo[4];
    split_tf32(x0.x, ahi[0], alo[0]);
    split_tf32(x1.x, ahi[1], alo[1]);
    split_tf32(x0.y, ahi[2], alo[2]);
    split_tf32(x1.y, ahi[3], alo[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 y = *reinterpret_cast<const float2*>(b + 8 * t * kXLdK + kk);
      uint32_t bhi[2], blo[2];
      split_tf32(y.x, bhi[0], blo[0]);
      split_tf32(y.y, bhi[1], blo[1]);
      mma_tf32x3(partial[t], ahi, alo, bhi, blo);
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] += partial[t][e];
}

// A block of 8 warps owns 64 query rows (4 warp rows of 16) and the whole
// width of O, two column halves of half_w (a multiple of 32, at most 8 NT),
// one a warp; O stays in registers, NT tiles of 8 columns a warp. It walks
// the key tiles as a sequence of ring stages: the q and k chunks of s, then
// the rows of v. Each warp forms its 16 x 32 of s once per tile; the two
// warps of a row exchange their row maxima through shared memory, so both
// scale by the same running max; each writes its p, split into its TF32
// halves, to shared memory; then each warp adds its rows of P times its
// half of v to O, after scaling O by the tile's alpha. Each warp keeps the
// row sums of its own 32 keys a tile; the two halves' are added at the end.
template <int NT>
__global__ void __launch_bounds__(kXThreads)
nonlocal_attention_fwd_tf32x3_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     float* __restrict__ out,
                                     float* __restrict__ lse, int n, int nk,
                                     int c, int cv, int half_w, float scale) {
  constexpr int kLdV = 16 * NT + 4;
  constexpr int kKV = tf32x3_v_rows(NT);
  constexpr int kVStages = kXKeys / kKV;
  static_assert(NT % 4 == 0 && kKV * kLdV <= kXSlot, "v rows fit a slot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* ps_hi = ring + kXStages * kXSlot;    // P (64 x 64): TF32 halves
  float* ps_lo = ps_hi + kXRows * kXLdP;
  float* red = ps_lo + kXRows * kXLdP;       // [2][64]: a half's row max / sum

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int wr = (warp & 3) * 16;     // the warp's first row in the block
  const int half = warp >> 2;         // its half of the keys and of O
  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * kXRows;
  const int col0 = half * half_w;     // the warp's first column of O
  const int cols = min(cv - col0, half_w);   // ... and how many it stores
  const int live = (cols + 7) / 8;           // its tiles that hold them
  const float* qb = q + (size_t)bi * n * c;
  const float* kb = k + (size_t)bi * nk * c;
  const float* vb = v + (size_t)bi * nk * cv;
  const bool vec_qk = c % 4 == 0 && aligned16(q) && aligned16(k);
  const bool vec_v = cv % 4 == 0 && aligned16(v);

  const int n_s = (c + kXK - 1) / kXK;
  const int per_tile = n_s + kVStages;
  const int total = (nk + kXKeys - 1) / kXKeys * per_tile;

  // Start stage st's loads into its slot; one commit group per call, empty
  // past the end, so that the wait below counts stages.
  auto issue = [&](int st) {
    if (st < total) {
      float* slot = ring + (st % kXStages) * kXSlot;
      const int k0 = st / per_tile * kXKeys, j = st % per_tile;
      if (j < n_s) {
        load_tile_f32_async<kXRows, kXK, kXThreads>(
            slot, kXLdK, qb, c, q0, n, j * kXK, c, vec_qk);
        load_tile_f32_async<kXKeys, kXK, kXThreads>(
            slot + kXRows * kXLdK, kXLdK, kb, c, k0, nk, j * kXK, c, vec_qk);
      } else {
        load_tile_f32_async<kKV, 16 * NT, kXThreads>(
            slot, kLdV, vb, cv, k0 + (j - n_s) * kKV, nk, 0, cv, vec_v);
      }
    }
    cp_async_commit();
  };
  int st = 0;   // the next stage to use
  auto next_slot = [&]() -> const float* {
    cp_async_wait<kXStages - 2>();   // stage st has landed (this thread's)
    __syncthreads();                 // ... every thread's; slot st - 1 free
    issue(st + kXStages - 1);
    return ring + (st++ % kXStages) * kXSlot;
  };

  // rows wr + g (h = 0) and wr + g + 8 (h = 1) of the warp: the running max
  // and this thread's share of the row sum (its 8 keys of each tile)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // acc[t][0..1]: row wr + g, columns col0 + 8t + 2qd + {0, 1}; [2..3]: row
  // + 8
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int s0 = 0; s0 < kXStages - 1; ++s0) issue(s0);
  for (int k0 = 0; k0 < nk; k0 += kXKeys) {
    // the warp's 16 x 32 of s: keys 32 half + 8t + 2qd + {0, 1}
    float s[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    for (int j = 0; j < n_s; ++j) tf32x3_s_chunk(s, next_slot(), wr, half);

    // ---- scale, mask the keys past nk, and the row maxima of both halves.
    // red is free: its last readers passed this tile's first barrier.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 32 * half + 8 * t + 2 * qd + (e & 1);
        s[t][e] = key < nk ? s[t][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (qd == 0) red[half * kXRows + wr + g + 8 * h] = mx[h];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rt = wr + g + 8 * h;
      const float m_new = fmaxf(m_r[h], fmaxf(red[rt], red[kXRows + rt]));
      alpha[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }

    // ---- p into ps as its TF32 halves. ps is free: the previous tile's v
    // stages are behind this tile's first barrier.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ct = 32 * half + 8 * t + 2 * qd;   // key in the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = wr + g + 8 * h;             // row in the block
        float2 hi, lo;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[t][2 * h + e] - m_r[h]);
          l_r[h] += p;
          uint32_t ph, pl;
          split_tf32(p, ph, pl);
          (e ? hi.y : hi.x) = __uint_as_float(ph);
          (e ? lo.y : lo.x) = __uint_as_float(pl);
        }
        *reinterpret_cast<float2*>(ps_hi + rt * kXLdP + ct) = hi;
        *reinterpret_cast<float2*>(ps_lo + rt * kXLdP + ct) = lo;
      }
    }

    // ---- O = alpha O + P v, kKV rows of v a stage; P's A fragments come
    // from ps already split, v's B fragments are split here. Four 8-column
    // tiles at a time, whose stage sums start from zero and join O by f32
    // adds.
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }
    for (int j = 0; j < kVStages; ++j) {
      const float* slot = next_slot();   // also: every warp's P is in ps
      const float* ah = ps_hi + (wr + g) * kXLdP + j * kKV + 2 * qd;
      const float* al = ps_lo + (wr + g) * kXLdP + j * kKV + 2 * qd;
      const float* b = slot + 2 * qd * kLdV + col0 + g;
#pragma unroll
      for (int t0 = 0; t0 < NT; t0 += 4) {
        if (t0 >= live) break;    // the warp's tiles past its columns
        float partial[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kKV; kk += 8) {
          const float2 h0 = *reinterpret_cast<const float2*>(ah + kk);
          const float2 h1 =
              *reinterpret_cast<const float2*>(ah + 8 * kXLdP + kk);
          const float2 l0 = *reinterpret_cast<const float2*>(al + kk);
          const float2 l1 =
              *reinterpret_cast<const float2*>(al + 8 * kXLdP + kk);
          const uint32_t ahi[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                   __float_as_uint(h0.y), __float_as_uint(h1.y)};
          const uint32_t alo[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                   __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float* bt = b + kk * kLdV + 8 * (t0 + t);
            uint32_t bhi[2], blo[2];
            split_tf32(bt[0], bhi[0], blo[0]);
            split_tf32(bt[kLdV], bhi[1], blo[1]);
            mma_tf32x3(partial[t], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t0 + t][e] += partial[t][e];
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none in flight

  // ---- epilogue: the row sums of the quad, then of both halves (red is
  // free: the last tile's v stages are behind its last read)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    if (qd == 0) red[half * kXRows + wr + g + 8 * h] = l_r[h];
  }
  __syncthreads();
  const bool pairs = cv % 2 == 0;   // 8-byte aligned float2 stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rt = wr + g + 8 * h;
    const int row = q0 + rt;
    if (row >= n) continue;
    const float l = red[rt] + red[kXRows + rt];
    const float inv_l = 1.f / l;
    if (half == 0 && qd == 0) lse[(size_t)bi * n + row] = m_r[h] + logf(l);
    float* orow = out + ((size_t)bi * n + row) * cv + col0;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = 8 * t + 2 * qd;
      if (col >= cols) break;
      const float o0 = acc[t][2 * h] * inv_l, o1 = acc[t][2 * h + 1] * inv_l;
      if (pairs) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
      } else {
        orow[col] = o0;
        if (col + 1 < cols) orow[col + 1] = o1;
      }
    }
  }
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
// C and Cv multiples of 8, at most 256 (the dispatch in
// ops/cuda/nonlocal_attention.py), padded to Cp and Cvp (multiples of 64)
// by the maps' zero fill. A block owns (batch item, 128 queries):
// warpgroups 0 and 1 consume 64 query rows each, warpgroup 2 produces
// (one thread issues every TMA copy). Shared memory, each tile a stack of
// swizzled 64-channel chunks (wgmma_tiles.cuh):
//   q      128 x Cp, loaded once             (256 Cp bytes)
//   k ring 2 slots of 64 keys x Cp           (256 Cp bytes)
//   v ring 2 slots of 64 keys x Cvp          (256 Cvp bytes; O's staging
//                                             at the end)
// 192 KB at C = Cv = 256. Per key tile a consumer forms S = q k^T (64 x 64,
// wgmma m64n64k16, both operands in shared memory), the online softmax in
// registers (a row across the 4 threads of a quad), P in bf16 straight from
// the accumulator, then O += P v (wgmma with A = P from registers, B = v
// MN-major: m64n256k16 at Cvp = 256, Cvp / 64 m64n64k16 otherwise). O (64
// x Cvp f32) stays in NV x 32 registers a thread, NV = Cvp / 64 fixed at
// compile time (one instantiation per NV, so a narrow Cv holds no idle
// accumulator and no branch guards a product): no Cv split, no recompute.
// Every expected transaction count is that of whole boxes (rows x Cp x 2
// bytes): TMA counts the zeros it fills, past the rows and past the
// columns alike.
constexpr int kWQ = 128;            // query rows per block
constexpr int kWK = 64;             // keys per tile

// C and Cv rounded up to whole 64-channel boxes
int padded(int width) { return (width + 63) / 64 * 64; }

size_t fwd_wgmma_smem(int cp, int cvp) {
  return 512 * (size_t)cp + 256 * (size_t)cvp + 2 * sizeof(Ring<2>) +
         sizeof(uint64_t) + 1024;   // + 1024: aligning the base
}

template <int NV>
__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __grid_constant__ CUtensorMap omap,
                                    float* __restrict__ lse, int n, int nk,
                                    int cp, float scale) {
  constexpr int cvp = 64 * NV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + 256 * cp;
  unsigned char* vs = ks + 256 * cp;
  Ring<2>* kring = reinterpret_cast<Ring<2>*>(vs + 256 * cvp);
  Ring<2>* vring = kring + 1;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vring + 1);

  const int nc = cp / 64;
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
      mbar_expect_tx(qbar, kWQ * cp * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(qs + j * kWQ * 128, &qmap, qbar, 64 * j, q0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<2>::slot(t);
        kring->wait_empty(t);
        mbar_expect_tx(&kring->full[s], kWK * cp * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(ks + s * 128 * cp + j * 8192, &kmap, &kring->full[s],
                   64 * j, t * kWK, bi);
        vring->wait_empty(t);
        mbar_expect_tx(&vring->full[s], kWK * cvp * 2);
        for (int j = 0; j < NV; ++j)
          tma_load(vs + s * 128 * cvp + j * 8192, &vmap, &vring->full[s],
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

    float o[NV][32];
#pragma unroll
    for (int j = 0; j < NV; ++j)
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
      ss_scores(sc, q_rows, kWQ * 128, smem_addr(ks) + s * 128 * cp, nc);
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
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_to_a(pa[j], sc, j);

      // ---- O += P v
      vring->wait_full(t);
      const uint32_t vt = smem_addr(vs) + s * 128 * cvp;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rs_chunks(o, pa[kk], vt + kk * 16 * 128, 64 * 128);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < NV; ++j) reg_fence(o[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) reg_fence(pa[j]);
      vring->release(t);
    }

    // ---- epilogue: O / l in bf16 through the v ring (free once both
    // consumer warpgroups are past their last product), one TMA store per
    // 64-column chunk of this warpgroup's rows (columns past Cv and rows
    // past N clipped); lse in f32
    named_sync(1, 256);
    float inv_l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv_l[h] = 1.f / l_i[h];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
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
      for (int j = 0; j < NV; ++j)
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

template <int NV>
int launch_fwd_narrow(const CUtensorMap& qm, const CUtensorMap& km,
                      const CUtensorMap& vm, const CUtensorMap& om,
                      float* lse, int b, int n, int nk, int cp, float scale,
                      cudaStream_t stream) {
  const size_t smem = fwd_wgmma_smem(cp, 64 * NV);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(nonlocal_attention_fwd_wgmma_kernel<NV>,
                                     smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kWQ - 1) / kWQ, b);
  nonlocal_attention_fwd_wgmma_kernel<NV><<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, om, lse, n, nk, cp, scale);
  return (int)cudaGetLastError();
}

int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int b, int n, int nk, int c, int cv,
                     float scale, cudaStream_t stream) {
  if (c % 8 || cv % 8 || c > 256 || cv > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, b, n, c, kWQ) || !make_map(&km, k, b, nk, c, kWK) ||
      !make_map(&vm, v, b, nk, cv, kWK) || !make_map(&om, out, b, n, cv, 64))
    return (int)cudaErrorNotSupported;
  const int cp = padded(c);
  switch (padded(cv) / 64) {
    case 1: return launch_fwd_narrow<1>(qm, km, vm, om, lse, b, n, nk, cp,
                                        scale, stream);
    case 2: return launch_fwd_narrow<2>(qm, km, vm, om, lse, b, n, nk, cp,
                                        scale, stream);
    case 3: return launch_fwd_narrow<3>(qm, km, vm, om, lse, b, n, nk, cp,
                                        scale, stream);
    default: return launch_fwd_narrow<4>(qm, km, vm, om, lse, b, n, nk, cp,
                                         scale, stream);
  }
}

// ------------------------------- bf16, Hopper: the wide forward (layer 3)
// C and Cv multiples of 8 up to 512, one of them above 256 (the dispatch
// in ops/cuda/nonlocal_attention.py; layer 3 of nonlocalresnet3d50, C = Cv
// = 512, N = Nk = 784 at 32 frames x 224 px; biggan256's SAGAN attention,
// C = 96, Cv = 384, N = 4096, Nk = 1024), padded to Cp and Cvp by the
// maps' zero fill as above.
//
// What bounds it. At (B, N, Nk, C, Cv) = (20, 784, 784, 512, 512) the
// function needs 2 B N Nk (C + Cv) = 25.2 GFLOP, 0.0255 ms at the bf16
// peak, against 0.0071 ms for its bytes. The kernel above cannot take the
// width: its O (64 x Cv f32) would need 256 registers a thread, and q for
// 128 rows plus two k and two v slots 384 KB of shared memory.
//
// Design. A block owns (batch item, 64 queries): ceil(N / 64) x B blocks,
// 260 at B = 20, 13 at B = 1. Warpgroup 2 produces (one thread issues every
// TMA copy); consumer warpgroups 0 and 1 both read the same 64 query rows
// and consumer g owns O[:, 64 W g .. 64 W g + 64 W), W = Cvp / 128 rounded up
// 64-column chunks, 64 x 256 f32 (128 registers a thread) at Cv = 512.
// Both form the whole S = q k^T over C (the products' A = q and B = k
// from shared memory), so the same online softmax runs in both, and each
// multiplies P into its half of v: 1.5x the minimal products at C = Cv,
// with no exchange and no barrier between the consumers inside the loop.
// Shared memory, each tile a stack of swizzled 64-channel chunks
// (wgmma_tiles.cuh):
//   q       64 x Cp, loaded once                (128 Cp bytes)
//   k ring  kFwdWideStages slots of kFwdWideTk keys x Cp
//   v ring  the same of kFwdWideTk keys x 2W chunks (each consumer's
//           product reads W chunks whether or not they all exist, so no
//           branch guards a wgmma; O's staging at the end)
// 192 KB at C = Cv = 512 with one slot of 64 keys each: S is m64n64k16,
// whose operands the tensor cores read from shared memory no faster than
// they multiply them (4 KB in 32 clocks); 2 slots of 32 keys would halve
// S's N and make it wait on shared memory (`tools/port_kernel_probes.py
// wide` times both, PERF.md). The ragged last key tile (784 =
// 12 x 64 + 16) reads zeros past Nk, masked at -1e30; the last query band
// reads zeros, and its rows past N are clipped by the TMA store. lse is
// written once per row, by consumer 0.
constexpr int kFwdWideTk = 64;      // keys per ring slot
constexpr int kFwdWideStages = 1;   // ring slots
static_assert(kFwdWideTk * kFwdWideStages >= 64,
              "O is staged in the v ring: 64 rows x 2W chunks");

template <int W>
size_t fwd_wide_smem(int cp) {
  return 128 * (size_t)cp +
         (size_t)kFwdWideStages * kFwdWideTk * (2 * cp + 2 * W * 128) +
         2 * sizeof(Ring<kFwdWideStages>) + sizeof(uint64_t) + 1024;
}

template <int W>
__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_fwd_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap omap,
                                   float* __restrict__ lse, int n, int nk,
                                   int cp, int cvp, float scale) {
  constexpr int TK = kFwdWideTk, ST = kFwdWideStages;
  constexpr int kVSlot = 2 * W * TK * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + 128 * cp;
  unsigned char* vs = ks + ST * TK * 2 * cp;
  Ring<ST>* kring = reinterpret_cast<Ring<ST>*>(vs + ST * kVSlot);
  Ring<ST>* vring = kring + 1;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vring + 1);

  const int nc = cp / 64, nv = cvp / 64;
  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tiles = (nk + TK - 1) / TK;
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
      mbar_expect_tx(qbar, 64 * cp * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(qs + j * 8192, &qmap, qbar, 64 * j, q0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<ST>::slot(t);
        kring->wait_empty(t);
        mbar_expect_tx(&kring->full[s], TK * cp * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(ks + s * TK * 2 * cp + j * TK * 128, &kmap,
                   &kring->full[s], 64 * j, t * TK, bi);
        vring->wait_empty(t);
        mbar_expect_tx(&vring->full[s], TK * cvp * 2);
        for (int j = 0; j < nv; ++j)
          tma_load(vs + s * kVSlot + j * TK * 128, &vmap, &vring->full[s],
                   64 * j, t * TK, bi);
      }
    }
  } else {
    // ---- consumers: the same 64 query rows, W chunks of O each
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const float sl2 = scale * kLog2e;   // scores in log2 units
    const int j0 = wg * W;              // this consumer's first O chunk

    float o[W][32];
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf};
    float l_i[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = Ring<ST>::slot(t);
      // ---- S = q k^T over all of C
      float sc[TK / 2];
      kring->wait_full(t);
      wgmma_fence();
      ss_scores(sc, smem_addr(qs), 8192, smem_addr(ks) + s * TK * 2 * cp, nc,
                TK * 128);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      kring->release(t);

      // ---- online softmax; keys past nk (zero-filled) are masked
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        const int key = t * TK + 8 * (i >> 2) + 2 * qd + (i & 1);
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
      for (int i = 0; i < TK / 2; ++i) {
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
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int j = 0; j < TK / 16; ++j) acc_to_a(pa[j], sc, j);

      // ---- O[:, this consumer's chunks] += P v[:, the same chunks]
      vring->wait_full(t);
      const uint32_t vt = smem_addr(vs) + s * kVSlot + j0 * TK * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        rs_chunks(o, pa[kk], vt + kk * 16 * 128, TK * 128);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < W; ++j) reg_fence(o[j]);
#pragma unroll
      for (int j = 0; j < TK / 16; ++j) reg_fence(pa[j]);
      vring->release(t);
    }

    // ---- epilogue: O / l in bf16 through the v ring (free once both
    // consumers are past their last product), one TMA store per existing
    // 64-column chunk (columns past Cv and rows past N clipped); lse in f32
    // from consumer 0
    named_sync(1, 256);
    float inv_l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv_l[h] = 1.f / l_i[h];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j0 + j >= nv) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const int r = warp * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(
            vs + (j0 + j) * 8192 + swizzled_pair(r, 8 * (i >> 2) + 2 * qd)) =
            pack_pair(o[j][i] * inv_l[h], o[j][i + 1] * inv_l[h]);
      }
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (tid == 0) {
      for (int j = j0; j < j0 + W && j < nv; ++j)
        tma_store(&omap, vs + j * 8192, 64 * j, q0, bi);
      tma_store_drain();
    }
    if (wg == 0 && qd == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + warp * 16 + g + 8 * h;
        if (row < n)
          lse[(size_t)bi * n + row] = (m_i[h] + log2f(l_i[h])) * kLn2;
      }
    }
  }
}

template <int W>
int launch_fwd_wide(const CUtensorMap& qm, const CUtensorMap& km,
                    const CUtensorMap& vm, const CUtensorMap& om, float* lse,
                    int b, int n, int nk, int cp, int cvp, float scale,
                    cudaStream_t stream) {
  const size_t smem = fwd_wide_smem<W>(cp);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(nonlocal_attention_fwd_wide_kernel<W>,
                                     smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 63) / 64, b);
  nonlocal_attention_fwd_wide_kernel<W><<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, om, lse, n, nk, cp, cvp, scale);
  return (int)cudaGetLastError();
}

int launch_fwd_wgmma_wide(const void* q, const void* k, const void* v,
                          void* out, float* lse, int b, int n, int nk, int c,
                          int cv, float scale, cudaStream_t stream) {
  if (c % 8 || cv % 8 || c > 512 || cv > 512 || (c <= 256 && cv <= 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, b, n, c, 64) ||
      !make_map(&km, k, b, nk, c, kFwdWideTk) ||
      !make_map(&vm, v, b, nk, cv, kFwdWideTk) ||
      !make_map(&om, out, b, n, cv, 64))
    return (int)cudaErrorNotSupported;
  const int cp = padded(c), cvp = padded(cv);
  switch ((cvp / 64 + 1) / 2) {
    case 1: return launch_fwd_wide<1>(qm, km, vm, om, lse, b, n, nk, cp, cvp,
                                      scale, stream);
    case 2: return launch_fwd_wide<2>(qm, km, vm, om, lse, b, n, nk, cp, cvp,
                                      scale, stream);
    case 3: return launch_fwd_wide<3>(qm, km, vm, om, lse, b, n, nk, cp, cvp,
                                      scale, stream);
    default: return launch_fwd_wide<4>(qm, km, vm, om, lse, b, n, nk, cp,
                                       cvp, scale, stream);
  }
}

// ------------------------------------------------- tf32x3: launch
template <int NT>
int launch_fwd_tf32x3_nt(const float* q, const float* k, const float* v,
                         float* out, float* lse, int b, int n, int nk, int c,
                         int cv, int half_w, float scale,
                         cudaStream_t stream) {
  auto kernel = nonlocal_attention_fwd_tf32x3_kernel<NT>;
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, kXSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kXRows - 1) / kXRows, b);
  kernel<<<grid, kXThreads, kXSmem, stream>>>(q, k, v, out, lse, n, nk, c, cv,
                                              half_w, scale);
  return (int)cudaGetLastError();
}

// Each half of O takes ceil(Cv / 2) columns rounded up to 32 (whole
// 4-tile groups); the program instantiated for the narrowest accumulator
// that holds them.
int launch_fwd_tf32x3(const float* q, const float* k, const float* v,
                      float* out, float* lse, int b, int n, int nk, int c,
                      int cv, float scale, cudaStream_t stream) {
  const int half_w = ((cv + 1) / 2 + 31) / 32 * 32;
  const int want = half_w / 8;
  switch (want <= 4 ? 4 : want <= 8 ? 8 : want <= 16 ? 16 : want <= 24 ? 24
                                                                       : 32) {
    case 4: return launch_fwd_tf32x3_nt<4>(q, k, v, out, lse, b, n, nk, c, cv,
                                           half_w, scale, stream);
    case 8: return launch_fwd_tf32x3_nt<8>(q, k, v, out, lse, b, n, nk, c, cv,
                                           half_w, scale, stream);
    case 16: return launch_fwd_tf32x3_nt<16>(q, k, v, out, lse, b, n, nk, c,
                                             cv, half_w, scale, stream);
    case 24: return launch_fwd_tf32x3_nt<24>(q, k, v, out, lse, b, n, nk, c,
                                             cv, half_w, scale, stream);
    default: return launch_fwd_tf32x3_nt<32>(q, k, v, out, lse, b, n, nk, c,
                                             cv, half_w, scale, stream);
  }
}


// ------------------------- f32, Hopper: TF32 wgmma + TMA (tf32_wgmma)
// The f32 K1-fwd (`_attn_kernel`) for C and Cv up to 512 on Hopper's
// tensor-core instruction: the arithmetic of tf32x3 above (three TF32
// products per f32 product, lo hi + hi lo + hi hi, every sum on the tensor
// cores short and joined by an f32 add) on wgmma.mma_async m64nNk8.f32.
// tf32.tf32, the layout of the f32 K1-dq and K1-dkv
// (nonlocal_attention_bwd_tf32_wgmma_kernel) made forward-shaped.
//
// TF32 wgmma reads both operands from shared memory K-major only. s = q k^T
// contracts over channels, so q and k are K-major as stored; P v contracts
// over keys, so v must arrive transposed, (Cv, Nk), keys contiguous. A
// pre-pass (tf32_split_kernel, tf32_wgmma.cuh; three launches a call)
// writes into scratch the wrapper allocates q's and k's TF32 halves as
// stored, (2B, rows, C padded to 32), and v's transposed, (2B, Cv padded to
// 32, Nk padded to 4): hi of item b at 2b, lo at 2b + 1, one TMA map each.
// Widths off 32 (the tests' C = 7, Cv = 5; MNIST's 16) are zero-padded
// there, so the main kernel never sees a width TMA cannot take: zero
// channels add nothing to s, and O's columns past Cv are not stored. No
// warp splits an operand in the main kernel.
//
// A block owns 64 query rows and 2 WN columns of O (WN = 32, 64, 96 or
// 128; past 256 columns grid.z walks parts of at most 256, each forming s
// again: 1.5x the products at layer 3's C = Cv = 512, 1.2x at SAGAN's 96 /
// 384). Warpgroup 2 produces (one thread issues every TMA copy into a ring
// of kFStages 32 KB slots: per 64-key tile the q and k chunks of s, then
// four v^T stages); consumer warpgroups 0 and 1 take the tiles in step:
//   s: each consumer forms its 32 key columns of the 64 x 64 tile
//     (m64n32k8) over 32-channel stages, kFUnroll at a time, each summed
//     from zero on the tensor cores and joined to s by an f32 add;
//   the two consumers exchange their rows' maxima through shared memory
//     (one named barrier a tile, which also frees P: both finished the
//     previous tile's P v before reaching it);
//   P = exp(s - m), split into its TF32 halves, written K-major and
//     swizzled into the P buffer (each consumer its 32 keys), read by both;
//   each consumer multiplies all of P (SS) by its WN columns of v^T, two
//     stages of 32 keys summed from zero (m64nWNk8), then O = alpha O +
//     partial in f32: the promotion and the online softmax's rescale are
//     one pass.
// Each consumer keeps the row sums of its own keys; both halves' are added
// at the end, and lse = m + log(l) as in tf32x3. Every wgmma group is
// waited on in the loop iteration that issued it (left pending across
// iterations, ptxas serializes the wgmmas: nonlocal_attention_bwd.cu).
// Registers at WN = 128: O 64, its partial 64, s 16, two stage partials 32.
//
// What bounds it: operations, 1.953 ms at layer 2 (B = 8) at the TF32 rate
// over 3 (the header). It takes 3.45 ms there against tf32x3's 10.06 (H100
// 80GB HBM3, 700 W; PERF.md), and tools/port_kernel_probes.py tw32fwd
// finds the pace in neither the products (one TF32 product instead of
// three: -3 to -6%) nor the pre-pass (0.19 ms); each 64-key tile moves 12
// ring stages from L2, q's chunks again every tile. Eight score stages at
// a time beat pairs by 10%, 6 slots beat 4 by 8-11%; parts of 128 columns
// instead of 256 cost 57% at layer 3. Summed over all keys on the tensor
// cores instead of promoted, out sat 1.2e-5 from f64 at layer 2 (promoted
// 1.8e-7, the plain f32 forward 4.9e-7) at the same time.
constexpr int kFRows = 64;        // query rows per block
constexpr int kFKeys = 64;        // keys per tile
constexpr int kFChunk = 32;       // channels per stage: a 128-byte f32 row
constexpr int kFStages = 6;       // ring slots
constexpr int kFUnroll = 8;       // score stages issued back to back
constexpr int kFPBytes = 32768;   // P: 2 halves x 2 chunks of 32 keys
constexpr int kFMaxPart = 256;    // O's columns a block takes at most
constexpr int kFMaxWidth = 512;

struct TfParams {
  float* out;
  float* lse;
  int n, nk, cv;
  int nc;               // 32-channel stages of s
  float scale;
};

size_t tf_smem() {
  return (size_t)kFStages * kGSlot + kFPBytes + sizeof(Ring<kFStages>) +
         4 * kFRows * sizeof(float) +   // the consumers' row maxima, sums
         1024;                          // aligning the base
}

// A completed stage's partial p joins s by f32 adds.
__device__ __forceinline__ void tf_join(float (&s)[16], float (&p)[16]) {
  reg_fence(p);
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] += p[e];
}

// The tile's U score stages st .. st + U - 1 into p0 and p1 in turn: each
// joins s once the stage after it is queued behind it, so the tensor cores
// drain once, after the last; each slot is released once read, and every
// wgmma group is waited on in this call.
template <int U, int ST>
__device__ __forceinline__ void tf_stages(float (&s)[16], float (&p0)[16],
                                          float (&p1)[16], Ring<ST>* ring,
                                          uint32_t ring_s, int st,
                                          uint32_t b_off) {
  tw_stage(p0, ring, ring_s, st, b_off);
#pragma unroll
  for (int i = 1; i < U; ++i) {
    if (i & 1) {
      tw_stage(p1, ring, ring_s, st + i, b_off);
      wgmma_wait<1>();
      tf_join(s, p0);
    } else {
      tw_stage(p0, ring, ring_s, st + i, b_off);
      wgmma_wait<1>();
      tf_join(s, p1);
    }
    ring->release(st + i - 1);
  }
  wgmma_wait<0>();
  if constexpr (U & 1) {
    tf_join(s, p0);
  } else {
    tf_join(s, p1);
  }
  ring->release(st + U - 1);
}

template <int WN>
__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_fwd_tf32_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const TfParams p) {
  constexpr int ST = kFStages;
  constexpr int kVBytes = WN * 128;   // one TF32 half of a v^T stage
  static_assert(2 * kVBytes <= kGSlot, "a v^T stage fits a slot");
  static_assert(ST >= 4, "a tile's four v^T stages are held at once");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_p = align1024(smem_raw);
  unsigned char* pbuf = ring_p + ST * kGSlot;
  Ring<ST>* ring = reinterpret_cast<Ring<ST>*>(pbuf + kFPBytes);
  float* red = reinterpret_cast<float*>(ring + 1);   // [2][64] max, [2][64] l

  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * kFRows;
  const int w_base = blockIdx.z * 2 * WN;
  const int tiles = (p.nk + kFKeys - 1) / kFKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    ring->init(kWConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: per tile the s stages, then the four v^T stages (key
    // chunk j / 2 of the tile for consumer j % 2)
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int st = 0;
      for (int t = 0; t < tiles; ++t) {
        const int k0 = t * kFKeys;
        for (int j = 0; j < p.nc; ++j, ++st) {
          unsigned char* slot = ring_p + Ring<ST>::slot(st) * kGSlot;
          uint64_t* full = &ring->full[Ring<ST>::slot(st)];
          ring->wait_empty(st);
          mbar_expect_tx(full, kGSlot);
          tma_load(slot, &qmap, full, j * kFChunk, r0, 2 * bi);
          tma_load(slot + 8192, &qmap, full, j * kFChunk, r0, 2 * bi + 1);
          tma_load(slot + 16384, &kmap, full, j * kFChunk, k0, 2 * bi);
          tma_load(slot + 24576, &kmap, full, j * kFChunk, k0, 2 * bi + 1);
        }
        for (int j = 0; j < 4; ++j, ++st) {
          unsigned char* slot = ring_p + Ring<ST>::slot(st) * kGSlot;
          uint64_t* full = &ring->full[Ring<ST>::slot(st)];
          const int key = k0 + (j >> 1) * kFChunk, row = w_base + (j & 1) * WN;
          ring->wait_empty(st);
          mbar_expect_tx(full, 2 * kVBytes);
          tma_load(slot, &vmap, full, key, row, 2 * bi);
          tma_load(slot + kVBytes, &vmap, full, key, row, 2 * bi + 1);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const uint32_t ring_s = smem_addr(ring_p);
    const uint32_t p_s = smem_addr(pbuf);
    // zeroed and pinned before the products: ptxas serializes the wgmmas
    // of an accumulator first defined inside the pipeline (C7515)
    float acc[WN / 2], pa[WN / 2], s[16], p0[16], p1[16];
#pragma unroll
    for (int e = 0; e < WN / 2; ++e) acc[e] = pa[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) p0[e] = p1[e] = 0.f;
    reg_fence(acc);
    reg_fence(pa);
    reg_fence(p0);
    reg_fence(p1);
    // rows warp * 16 + g (h = 0) and + 8 (h = 1) of the block: the running
    // max and this thread's share of the row sum (its 8 keys of each tile)
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

    const uint32_t b_off = wg * 4096;   // the consumer's 32 keys
    int st = 0;   // the next ring stage
    for (int t = 0; t < tiles; ++t) {
      const int k0 = t * kFKeys;
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      // ---- s: kFUnroll stages at a time, the rest by pairs, then one
      int js = 0;
      for (; js + kFUnroll <= p.nc; js += kFUnroll)
        tf_stages<kFUnroll>(s, p0, p1, ring, ring_s, st + js, b_off);
      for (; js + 2 <= p.nc; js += 2)
        tf_stages<2>(s, p0, p1, ring, ring_s, st + js, b_off);
      if (js < p.nc) tf_stages<1>(s, p0, p1, ring, ring_s, st + js, b_off);
      st += p.nc;

      // ---- scale, mask the keys past nk, and the row maxima of both
      // consumers (s[4 j + 2 h + e]: row warp * 16 + g + 8 h, key k0 + 32 wg
      // + 8 j + 2 qd + e)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 32 * wg + 8 * j + 2 * qd + (e & 1);
          float& x = s[4 * j + e];
          x = key < p.nk ? x * p.scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (qd == 0) red[wg * kFRows + warp * 16 + g + 8 * h] = mx[h];
      }
      // both maxima written; and P is free: each consumer's P v product of
      // tile t - 1 completed before it arrived here
      named_sync(2, 256);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float other = red[(1 - wg) * kFRows + warp * 16 + g + 8 * h];
        const float m_new = fmaxf(m_r[h], fmaxf(mx[h], other));
        alpha[h] = expf(m_r[h] - m_new);
        m_r[h] = m_new;
        l_r[h] *= alpha[h];
      }

      // ---- P: this consumer's keys, as TF32 halves into chunk wg
      unsigned char* pb = pbuf + wg * 8192;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ct = 8 * j + 2 * qd;           // key in the chunk
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = warp * 16 + g + 8 * h;  // row in the block
          float2 hi, lo;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = expf(s[4 * j + 2 * h + e] - m_r[h]);
            l_r[h] += x;
            uint32_t xh, xl;
            split_tf32(x, xh, xl);
            (e ? hi.y : hi.x) = __uint_as_float(xh);
            (e ? lo.y : lo.x) = __uint_as_float(xl);
          }
          *reinterpret_cast<float2*>(pb + swizzled_f32(rt, ct)) = hi;
          *reinterpret_cast<float2*>(pb + 16384 + swizzled_f32(rt, ct)) = lo;
        }
      }
      fence_proxy_async();
      named_sync(1, 256);   // P of both consumers written

      // ---- O = alpha O + P v^T over the tile's two key chunks: this
      // consumer's v^T stages are st + wg and st + 2 + wg, the other two it
      // releases at once; chunk 0's own slot is released as soon as its
      // group is done, so the next tile's stages load behind chunk 1's
#pragma unroll
      for (int j = 0; j < 4; ++j) ring->wait_full(st + j);
      ring->release(st + 1 - wg);
      ring->release(st + 3 - wg);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t m = ring_s + Ring<ST>::slot(st + 2 * i + wg) * kGSlot;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32x3(pa, p_s + i * 8192 + 32 * kk,
                       p_s + 16384 + i * 8192 + 32 * kk, m + 32 * kk,
                       m + kVBytes + 32 * kk, (i | kk) == 0);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();
      ring->release(st + wg);
      wgmma_wait<0>();
      reg_fence(pa);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e)
        acc[e] = acc[e] * alpha[(e >> 1) & 1] + pa[e];
      ring->release(st + 2 + wg);
      st += 4;
    }

    // ---- epilogue: the row sums of the quad, then of both consumers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
      if (qd == 0) red[(2 + wg) * kFRows + warp * 16 + g + 8 * h] = l_r[h];
    }
    named_sync(2, 256);
    const bool pairs = p.cv % 2 == 0;   // 8-byte aligned float2 stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rt = warp * 16 + g + 8 * h;
      const int row = r0 + rt;
      if (row >= p.n) continue;
      const float l = red[2 * kFRows + rt] + red[3 * kFRows + rt];
      const float inv_l = 1.f / l;
      if (wg == 0 && qd == 0 && blockIdx.z == 0)
        p.lse[(size_t)bi * p.n + row] = m_r[h] + logf(l);
      float* orow = p.out + ((size_t)bi * p.n + row) * p.cv;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = w_base + WN * wg + 8 * j + 2 * qd;
        const float o0 = acc[4 * j + 2 * h] * inv_l;
        const float o1 = acc[4 * j + 2 * h + 1] * inv_l;
        if (pairs && col + 1 < p.cv) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
        } else {
          if (col < p.cv) orow[col] = o0;
          if (col + 1 < p.cv) orow[col + 1] = o1;
        }
      }
    }
  }
}

// Bytes of the scratch a call takes: q's and k's TF32 halves as stored
// and v's transposed (tf32_wgmma.cuh), each region 256-byte aligned.
size_t tf_scratch_bytes(int b, int n, int nk, int c, int cv) {
  const int cp = round_up(c, kFChunk), cvp = round_up(cv, kFChunk);
  return tw_region(b, n, cp) + tw_region(b, nk, cp) +
         tw_region(b, cvp, round_up(nk, 4));
}

template <int WN>
int launch_tf(const CUtensorMap (&maps)[3], const TfParams& p, int b,
              int blocks, int z, cudaStream_t stream) {
  auto kernel = nonlocal_attention_fwd_tf32_wgmma_kernel<WN>;
  const size_t smem = tf_smem();
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(blocks, b, z), kWThreads, smem, stream>>>(maps[0], maps[1],
                                                         maps[2], p);
  return (int)cudaGetLastError();
}

// The pre-pass, then the main kernel. O's columns (Cv padded to 32) go
// over z parts of at most kFMaxPart, each of two consumers' WN columns:
// WN the narrowest of 32, 64, 96, 128 that covers a part.
int run_fwd_tf32_wgmma(const float* q, const float* k, const float* v,
                       float* out, float* lse, void* scratch, int b, int n,
                       int nk, int c, int cv, float scale,
                       cudaStream_t stream) {
  if (c > kFMaxWidth || cv > kFMaxWidth) return (int)cudaErrorInvalidValue;
  const int cp = round_up(c, kFChunk), cvp = round_up(cv, kFChunk);
  const int nkp = round_up(nk, 4);
  float* qs = static_cast<float*>(scratch);
  float* ks = qs + tw_region(b, n, cp) / sizeof(float);
  float* vt = ks + tw_region(b, nk, cp) / sizeof(float);
  int err;
  if ((err = launch_split(q, qs, nullptr, b, n, c, cp, stream)) ||
      (err = launch_split(k, ks, nullptr, b, nk, c, cp, stream)) ||
      (err = launch_split(v, nullptr, vt, b, nk, cv, cvp, stream)))
    return err;
  const int z = (cvp + kFMaxPart - 1) / kFMaxPart;
  const int half = ((cvp + z - 1) / z + 1) / 2;
  const int wn = round_up(half, 32);
  CUtensorMap maps[3];   // q, k, v^T
  if (!make_map_f32(&maps[0], qs, 2 * b, n, cp, kFRows) ||
      !make_map_f32(&maps[1], ks, 2 * b, nk, cp, kFKeys) ||
      !make_map_f32(&maps[2], vt, 2 * b, cvp, nkp, wn))
    return (int)cudaErrorNotSupported;
  TfParams p;
  p.out = out;
  p.lse = lse;
  p.n = n;
  p.nk = nk;
  p.cv = cv;
  p.nc = cp / kFChunk;
  p.scale = scale;
  const int blocks = (n + kFRows - 1) / kFRows;
  switch (wn) {
    case 32: return launch_tf<32>(maps, p, b, blocks, z, stream);
    case 64: return launch_tf<64>(maps, p, b, blocks, z, stream);
    case 96: return launch_tf<96>(maps, p, b, blocks, z, stream);
    default: return launch_tf<128>(maps, p, b, blocks, z, stream);
  }
}

}  // namespace

extern "C" {

// The f32 tensor-core program (tf32x3): the same function as
// pt_nonlocal_attention_fwd in f32, for C and Cv up to kXMaxWidth (the
// caller's dispatch picks it).
int pt_nonlocal_attention_fwd_tf32x3(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int b, int n, int nk, int c, int cv,
                                     float scale, void* stream) {
  if (b < 1 || n < 1 || nk < 1 || c < 1 || cv < 1 || b > 65535 ||
      c > kXMaxWidth || cv > kXMaxWidth)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_tf32x3(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), b, n, nk, c, cv, scale,
      static_cast<cudaStream_t>(stream));
}

// The f32 TF32-wgmma program (tf32_wgmma): the same function as
// pt_nonlocal_attention_fwd in f32, for C and Cv up to kFMaxWidth (the
// caller's dispatch picks it), with `scratch` (16-byte aligned) of
// pt_nonlocal_attention_fwd_tf32_wgmma_scratch bytes for the operands'
// TF32 halves. Any f32 tensors: the pre-pass reads them with plain loads.
long long pt_nonlocal_attention_fwd_tf32_wgmma_scratch(int b, int n, int nk,
                                                       int c, int cv) {
  return (long long)tf_scratch_bytes(b, n, nk, c, cv);
}

int pt_nonlocal_attention_fwd_tf32_wgmma(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         void* scratch, int b, int n, int nk,
                                         int c, int cv, float scale,
                                         void* stream) {
  if (b < 1 || n < 1 || nk < 1 || c < 1 || cv < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  return run_fwd_tf32_wgmma(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), scratch, b, n, nk, c, cv, scale,
      static_cast<cudaStream_t>(stream));
}

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
// for C and Cv multiples of 8 up to 256 and 16-byte aligned tensors (the
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

// The wide bf16 wgmma kernel: the same function, for C and Cv multiples of
// 8 up to 512 with one of them above 256, and 16-byte aligned tensors
// (the caller's dispatch picks it).
int pt_nonlocal_attention_fwd_wgmma_wide(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int b, int n, int nk, int c, int cv,
                                         float scale, void* stream) {
  if (b < 1 || n < 1 || nk < 1 || c < 1 || cv < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_wgmma_wide(q, k, v, out, static_cast<float*>(lse), b, n,
                               nk, c, cv, scale,
                               static_cast<cudaStream_t>(stream));
}

const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
