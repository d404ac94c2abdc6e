// Non-local attention backward for Hopper (sm_90a). With s = scale q k^T,
// p = exp(s - lse) (lse from the forward), delta = rowsum(do * out) and
// ds = p * (do v^T - delta) * scale:
//   dq = ds k          (kernel K1-dq)
//   dk = ds^T q,  dv = p^T do   (kernel K1-dkv)
//
// Replaces the TPU kernels `_attn_dq_kernel` and `_attn_dkv_kernel`
// (pretorched_tpu/ops/pallas/nonlocal_attention.py:141 and :172, launched
// by `_nonlocal_attention_bwd_blockwise` at l.237 and l.260). Same
// semantics: q (B, N, C), k (B, Nk, C), v (B, Nk, Cv), do (B, N, Cv), lse
// and delta (B, N) f32; dq, dk, dv in the inputs' type (f32 or bf16), f32
// accumulation; padded keys add nothing to dq and padded queries nothing
// to dk and dv.
//
// What bounds it. At the training path's layer-2 shape (B = 8, N = Nk =
// 6272, C = Cv = 256) the backward needs 5 products of 2 B N Nk C each, 2 B
// N Nk (3C + 2Cv) = 806 GFLOP, against ~0.2 GB of operands in bf16 (0.4 GB
// in f32): bound by the matrix units, 0.82 ms at the card's bf16 peak. In
// f32 each product is 3 TF32 products on the tensor cores (below), 2417
// GFLOP at the 495 TFLOP/s dense TF32 rate: 4.88 ms (K1-dq alone 2.93 ms,
// K1-dkv 3.91 ms at their minimal work); 12.0 ms on the 67 TFLOP/s of the
// CUDA cores.
//
// Design. The TPU kernels carry the dq (or dk, dv) accumulator in VMEM
// across a sequential grid axis. Blocks on a GPU run in no order, so each
// block owns a band of rows of one output and loops over the other axis
// itself; two kernels and no atomics, as on the TPU, so the gradient is the
// same from run to run. Both are one generic block program over "rows" (the
// block's own axis) and "cols" (the streamed axis):
//
//   K1-dq:  rows = queries, cols = keys:    X = ds,   acc += X k
//   K1-dkv: rows = keys,    cols = queries: X = ds^T, acc += X q  (dk)
//                                           X = p^T,  acc += X do (dv)
//
// For each 64-wide column tile the block forms s (and dp unless it makes
// dv) from channel chunks in shared memory, turns them into X in
// registers, and accumulates X times a 64-row tile of the third operand. In
// the generic programs (mma.sync in bf16, scalar in f32) a block keeps only
// a column chunk of its accumulator (128 columns in bf16, 64 in f32) in
// registers, and the chunks go over grid.z: C reaches 1024 in gaussian
// mode. Each chunk recomputes s and dp: at C = Cv = 256 in bf16 that is
// 2.6x the minimal FLOPs, bought for register-resident accumulators. dk and
// dv are separate chunks of the K1-dkv grid, so a dv block skips dp. The
// caller's dispatch picks one of six programs:
//
// * bf16 with C and Cv multiples of 64 up to 256 (the train layer-2
//   shape): warp-specialised wgmma kernels with TMA, which form s (s^T)
//   once and keep whole accumulators in registers
//   (nonlocal_attention_bwd_dq_wgmma_kernel and
//   nonlocal_attention_bwd_dkv_wgmma_kernel below, wgmma_tiles.cuh).
// * bf16 with C and Cv multiples of 64 up to 512, one above 256 (layer 3's
//   C = Cv = 512): wide wgmma kernels. K1-dkv's blocks each take one
//   column half of dk and dv (nonlocal_attention_bwd_dkv_wide_kernel);
//   K1-dq's two consumers split dq's columns
//   (nonlocal_attention_bwd_dq_wide_kernel).
// * bf16 otherwise (gaussian mode's widths, C = 1024):
//   tensor cores through mma.sync.m16n8k16, warps
//   of 16 rows (mma_tiles.cuh), fragments read by ldmatrix. X goes from the
//   C fragments straight into the A fragments of the accumulating product,
//   rounded to bf16 (as P is in the forward). The tiles stream through a
//   3-slot cp.async ring, so the tile after next loads while one is
//   multiplied; the third operand is staged untransposed and transposed by
//   ldmatrix.trans. Once the ring hides latency, the bound is L2: a block
//   that re-reads its own rows of q and do (K1-dq) for every column tile
//   moves 144 KB a tile. So where they fit (C, Cv <= 256, the training
//   path's layer 2) a block takes 128 rows on 8 warps and keeps its rows
//   resident in shared memory (186 KB), 40 KB a tile; wider channels take
//   64 rows on 4 warps and stream both operands.
// * f32 with C and Cv up to 512 (every f32 shape of the models but gaussian
//   mode's C = 1024): tf32_wgmma, the same arithmetic as tf32x3 below on
//   Hopper's TF32 wgmma with TMA (nonlocal_attention_bwd_tf32_wgmma_kernel
//   near the end of this file, and its pre-pass tf32_split_kernel in
//   tf32_wgmma.cuh). A
//   pre-pass splits each operand once into its TF32 halves in scratch,
//   the accumulating products' operand transposed, so that TF32 wgmma,
//   which reads both operands K-major only, takes every product from
//   shared memory; s and dp are formed once per tile and X goes through
//   shared memory, split. At layer 2 K1-dq 5.7 and K1-dkv 9.9 ms against
//   tf32x3's 16.3 and 27.4 (PERF.md). tf32x3 stays launchable by
//   name (the A/B against it).
// * f32 by name (the program tf32_wgmma replaced): tf32x3,
//   mma.sync.m16n8k8 in TF32 with three products per f32 product
//   (nonlocal_attention_bwd_tf32x3_kernel). One TF32
//   product keeps 11 bits of each operand and misses the f32 tolerance
//   (1e-4 of the largest gradient; 6.4e-4 at layer 2). Each operand is
//   split in registers into hi = tf32(x) and lo = tf32(x - hi)
//   (cvt.rna.tf32.f32's rounding, by an integer add and mask), and lo hi +
//   hi lo + hi hi, the small terms first (CUTLASS's OpMultiplyAddFastF32,
//   as PyTorch's f32 memory-efficient attention does), keeps about 22 of
//   f32's 24 bits; the dropped lo lo is ~2^-22 of each product. X is split
//   the same way before its product. The mma's own sums truncate: summed
//   there over 6272 keys the gradients sat 6e-5 of the largest from f64,
//   so every chunk of s and dp and every stage of X m is summed from zero
//   and joins its accumulator by an f32 add, which rounds to nearest: 3e-6
//   from f64 at layer 2, where the plain f32 backward sits 4e-6
//   (tools/port_kernel_probes.py tf32). A block of 8 warps owns 64 rows and the
//   whole width of its output up to 512 (4 warp rows of 16 x 2 column
//   halves; the accumulator, 64 KB at 256 and 128 KB at 512, stays in
//   registers), forms s and dp once per 64-column tile (each warp a 16 x
//   32 piece) and shares X through shared memory, so no chunk of the
//   output recomputes them. K1-dkv's dk and dv blocks are apart (grid.z =
//   2), and a dv block skips dp. Multiply-adds per (query, key) pair, at C
//   = Cv = 256 and at 512: K1-dq 768 / 1536 (C + Cv + C, the minimum),
//   K1-dkv 1280 / 2560 against the minimum 1024 / 2048 (the dv blocks
//   form s again); the scalar program's 64-column chunks did 2304 and 3584
//   at 256 (3.0x and 3.5x the minimum), 5.7x and 6.5x at 512. Every
//   operand streams through a 3-slot cp.async ring of 36 KB slots
//   (64-channel chunks of the rows and the tile's columns, then rows of the
//   third operand), so the chunk after next loads while one is multiplied;
//   144 KB a block, one block an SM (207 registers a thread at 256
//   columns, 247 at 512). The probe's variants put the time a third each in
//   the products, the copies from L2 and the rest (barriers, X): neither a
//   4-slot ring nor two blocks an SM (128 registers, spilling at 512)
//   changes it by more than 8%. Its split once per warp and its mma.sync
//   products are what tf32_wgmma replaced.
// * f32 otherwise (C or Cv above 512): scalar FMAs, 16 x 16 threads, each
//   with a 4 x 4 register tile; X passes through shared memory. Its third
//   operand is staged by plain loads between barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "tf32_wgmma.cuh"
#include "wgmma_tiles.cuh"

namespace {

// What the blocks of one grid.z range compute: out (rows x w) += X m, with
// m (cols x w); ds selects X = ds (dq, dk) or X = p (dv).
template <typename T>
struct Part {
  const T* m;
  T* out;
  int w;
  int ds;
};

template <typename T>
struct BwdParams {
  const T* ra;          // (rows x c): s = ra ca^T
  const T* ca;          // (cols x c)
  const T* rb;          // (rows x cv): dp = rb cb^T
  const T* cb;          // (cols x cv)
  const float* lse;     // (B x n_stats), n_stats = rows or cols
  const float* delta;
  int rows, cols, c, cv;
  float scale;
  int stats_on_rows;    // 1 for dq (lse, delta per query = per row)
  int zsplit;           // blocks with blockIdx.z < zsplit make part 0
  Part<T> part0, part1;
};

// ------------------------------------------------------------ f32, scalar
constexpr int kFR = 64;         // rows per block
constexpr int kFC = 64;         // columns per tile
constexpr int kFK = 32;         // channel chunk of s and dp
constexpr int kFW = 64;         // accumulator columns per block (grid.z)
constexpr int kFThreads = 256;  // 16 x 16

// acc[i][j] = a[r0 + ty + 16i, :] . b[c0 + tx + 16j, :] over ch channels,
// kFK at a time through shared memory (as, bs); rows past the ends are 0.
__device__ __forceinline__ void f32_tile_product(float (&acc)[4][4], float* as,
                                                 float* bs, const float* a,
                                                 const float* b, int ch, int r0,
                                                 int rows, int c0, int cols) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < ch; k0 += kFK) {
    __syncthreads();  // earlier readers of as, bs are done
    for (int e = tid; e < kFR * kFK; e += kFThreads) {
      const int r = e / kFK, cc = e % kFK;
      const int row_a = r0 + r, row_b = c0 + r, col = k0 + cc;
      as[r * (kFK + 1) + cc] =
          (row_a < rows && col < ch) ? a[(size_t)row_a * ch + col] : 0.f;
      bs[r * (kFK + 1) + cc] =
          (row_b < cols && col < ch) ? b[(size_t)row_b * ch + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < kFK; ++cc) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = as[(ty + 16 * i) * (kFK + 1) + cc];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = bs[(tx + 16 * j) * (kFK + 1) + cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
nonlocal_attention_bwd_f32_kernel(const BwdParams<float> p) {
  // stage: the ra/rb and ca/cb chunks, later the m tile [kFC][kFW + 1]
  __shared__ float stage[2 * kFR * (kFK + 1)];
  __shared__ float xs[kFR * (kFC + 1)];         // X tile
  __shared__ float lse_s[kFC], delta_s[kFC];    // per column (dk, dv)
  float* as = stage;
  float* bs = stage + kFR * (kFK + 1);
  float* ms = stage;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * kFR;
  const bool first = (int)blockIdx.z < p.zsplit;
  const Part<float> part = first ? p.part0 : p.part1;
  const int w0 = ((int)blockIdx.z - (first ? 0 : p.zsplit)) * kFW;
  const int n_stats = p.stats_on_rows ? p.rows : p.cols;
  const float* ra = p.ra + (size_t)bi * p.rows * p.c;
  const float* ca = p.ca + (size_t)bi * p.cols * p.c;
  const float* rb = p.rb + (size_t)bi * p.rows * p.cv;
  const float* cb = p.cb + (size_t)bi * p.cols * p.cv;
  const float* lse = p.lse + (size_t)bi * n_stats;
  const float* delta = p.delta + (size_t)bi * n_stats;
  const float* m = part.m + (size_t)bi * p.cols * part.w;

  float lse_r[4] = {0.f, 0.f, 0.f, 0.f}, delta_r[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.stats_on_rows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row < p.rows) {
        lse_r[i] = lse[row];
        delta_r[i] = delta[row];
      }
    }
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.cols; c0 += kFC) {
    // lse_s is free: every thread passed a barrier after its last read of it
    if (!p.stats_on_rows && tid < kFC) {
      const int col = c0 + tid;
      lse_s[tid] = col < p.cols ? lse[col] : 0.f;
      delta_s[tid] = col < p.cols ? delta[col] : 0.f;
    }
    // ---- s = ra ca^T and dp = rb cb^T for this tile
    float s[4][4], dp[4][4];
    f32_tile_product(s, as, bs, ra, ca, p.c, r0, p.rows, c0, p.cols);
    if (part.ds) f32_tile_product(dp, as, bs, rb, cb, p.cv, r0, p.rows, c0, p.cols);

    // ---- X = p or ds; zero outside the valid rows and columns. xs is
    // free: every thread passed a barrier after its last read of it.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = r0 + ty + 16 * i, col = c0 + tx + 16 * j;
        const float l = p.stats_on_rows ? lse_r[i] : lse_s[tx + 16 * j];
        const float d = p.stats_on_rows ? delta_r[i] : delta_s[tx + 16 * j];
        float x = 0.f;
        if (row < p.rows && col < p.cols) {
          x = expf(s[i][j] * p.scale - l);
          if (part.ds) x *= (dp[i][j] - d) * p.scale;
        }
        xs[(ty + 16 * i) * (kFC + 1) + tx + 16 * j] = x;
      }
    __syncthreads();  // xs written; every read of as, bs is done
    for (int e = tid; e < kFC * kFW; e += kFThreads) {
      const int r = e / kFW, cc = e % kFW;
      const int row = c0 + r, col = w0 + cc;
      ms[r * (kFW + 1) + cc] =
          (row < p.cols && col < part.w) ? m[(size_t)row * part.w + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFC; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xs[(ty + 16 * i) * (kFC + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = ms[kk * (kFW + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  float* out = part.out + (size_t)bi * p.rows * part.w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = w0 + tx + 16 * j;
      if (col < part.w) out[(size_t)row * part.w + col] = acc[i][j];
    }
  }
}

// ------------------------------------------- f32, tensor cores: tf32x3
constexpr int kTRows = 64;          // rows per block: 4 warp rows of 16
constexpr int kTCols = 64;          // streamed columns per tile
constexpr int kTK = 64;             // channel chunk of s and dp
constexpr int kTLdK = kTK + 8;      // 72 = 8 mod 32: 8-byte fragment loads
constexpr int kTLdX = kTCols + 8;   // of 8 rows x 4 lanes hit 32 banks
constexpr int kTThreads = 256;      // 8 warps: 4 warp rows x 2 column halves
constexpr int kTStages = 3;         // ring slots: one in use, two loading
constexpr int kTSlot = 2 * kTRows * kTLdK;   // floats: a row and a col chunk
constexpr size_t kTSmem =
    (kTStages * kTSlot + 2 * kTRows * kTLdX) * sizeof(float);   // 144 KB
// The widest accumulator a warp keeps, in 8-column tiles: a block owns 16 x
// kTMaxNT output columns (512); wider outputs go over grid.z.
constexpr int kTMaxNT = 32;
constexpr int kTMaxWidth = 512;     // the widest C, Cv the C entries take

// Rows of the third operand m a ring slot takes at NT tiles a warp: its
// rows are 16 NT + 4 floats (= 4 mod 32: the B fragments' 4-byte loads of
// rows 2qd and 2qd + 1, columns g, hit 32 banks).
__host__ __device__ constexpr int tf32_m_rows(int nt) {
  return 64 * (16 * nt + 4) <= kTSlot   ? 64
         : 32 * (16 * nt + 4) <= kTSlot ? 32
         : 16 * (16 * nt + 4) <= kTSlot ? 16
                                        : 8;
}

// acc[t] += the warp's 16 x 32 tile (rows wr.., columns 32 half + 8t..) of
// a b^T over one kTK-channel chunk: a (the block's rows) and b (the tile's
// columns) kTLdK apart in `slot`. The chunk's sum starts from zero on the
// tensor cores and joins acc by an f32 add (see mma_tf32x3).
__device__ __forceinline__ void tf32x3_chunk(float (&acc)[4][4],
                                             const float* slot, int wr,
                                             int half) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const float* a = slot + (wr + g) * kTLdK + 2 * qd;
  const float* b = slot + (kTRows + 32 * half + g) * kTLdK + 2 * qd;
  float partial[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kTK; kk += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * kTLdK + kk);
    uint32_t ahi[4], alo[4];
    split_tf32(x0.x, ahi[0], alo[0]);
    split_tf32(x1.x, ahi[1], alo[1]);
    split_tf32(x0.y, ahi[2], alo[2]);
    split_tf32(x1.y, ahi[3], alo[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 y = *reinterpret_cast<const float2*>(b + 8 * t * kTLdK + kk);
      uint32_t bhi[2], blo[2];
      split_tf32(y.x, bhi[0], blo[0]);
      split_tf32(y.y, bhi[1], blo[1]);
      mma_tf32x3(partial[t], ahi, alo, bhi, blo);
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] += partial[t][e];
}

// A block of 8 warps owns 64 rows (4 warp rows of 16) and 16 NT columns of
// one output (two halves of 8 NT, one a warp), and walks the column tiles
// as a sequence of ring stages: the s chunks, the dp chunks (ds parts
// only), then the m rows. Each warp forms its 16 x 32 of s (and dp), once
// for the block's whole width, turns it into X and leaves X split into its
// TF32 halves in shared memory; then each warp adds its rows of X times its
// half of m to its accumulator.
template <int NT>
__global__ void __launch_bounds__(kTThreads)
nonlocal_attention_bwd_tf32x3_kernel(const BwdParams<float> p) {
  constexpr int kLdM = 16 * NT + 4;
  constexpr int kKM = tf32_m_rows(NT);
  constexpr int kMStages = kTCols / kKM;
  static_assert(NT % 4 == 0 && kKM * kLdM <= kTSlot, "m rows fit a slot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* xs_hi = ring + kTStages * kTSlot;    // X (64 x 64): TF32 halves
  float* xs_lo = xs_hi + kTRows * kTLdX;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int wr = (warp & 3) * 16;     // the warp's first row in the block
  const int half = warp >> 2;         // its half of the block's columns
  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * kTRows;
  const bool first = (int)blockIdx.z < p.zsplit;
  const Part<float> part = first ? p.part0 : p.part1;
  const int w0 = ((int)blockIdx.z - (first ? 0 : p.zsplit)) * 16 * NT;
  // the warp's 8-column tiles that hold output columns
  const int live = (part.w - w0 - 8 * NT * half + 7) / 8;
  const int n_stats = p.stats_on_rows ? p.rows : p.cols;
  const float* ra = p.ra + (size_t)bi * p.rows * p.c;
  const float* ca = p.ca + (size_t)bi * p.cols * p.c;
  const float* rb = p.rb + (size_t)bi * p.rows * p.cv;
  const float* cb = p.cb + (size_t)bi * p.cols * p.cv;
  const float* lse = p.lse + (size_t)bi * n_stats;
  const float* delta = p.delta + (size_t)bi * n_stats;
  const float* m = part.m + (size_t)bi * p.cols * part.w;
  const bool vec_a = p.c % 4 == 0 && aligned16(p.ra) && aligned16(p.ca);
  const bool vec_b = p.cv % 4 == 0 && aligned16(p.rb) && aligned16(p.cb);
  const bool vec_m = part.w % 4 == 0 && aligned16(part.m);

  const int n_s = (p.c + kTK - 1) / kTK;
  const int n_dp = part.ds ? (p.cv + kTK - 1) / kTK : 0;
  const int per_tile = n_s + n_dp + kMStages;
  const int total = (p.cols + kTCols - 1) / kTCols * per_tile;

  // Start stage st's loads into its slot; one commit group per call, empty
  // past the end, so that the wait below counts stages.
  auto issue = [&](int st) {
    if (st < total) {
      float* slot = ring + (st % kTStages) * kTSlot;
      const int c0 = st / per_tile * kTCols, j = st % per_tile;
      if (j < n_s + n_dp) {
        const bool is_s = j < n_s;
        const int k0 = (is_s ? j : j - n_s) * kTK;
        const int ch = is_s ? p.c : p.cv;
        const bool vec = is_s ? vec_a : vec_b;
        load_tile_f32_async<kTRows, kTK, kTThreads>(
            slot, kTLdK, is_s ? ra : rb, ch, r0, p.rows, k0, ch, vec);
        load_tile_f32_async<kTCols, kTK, kTThreads>(
            slot + kTRows * kTLdK, kTLdK, is_s ? ca : cb, ch, c0, p.cols,
            k0, ch, vec);
      } else {
        load_tile_f32_async<kKM, 16 * NT, kTThreads>(
            slot, kLdM, m, part.w, c0 + (j - n_s - n_dp) * kKM, p.cols, w0,
            part.w, vec_m);
      }
    }
    cp_async_commit();
  };
  int st = 0;   // the next stage to use
  auto next_slot = [&]() -> const float* {
    cp_async_wait<kTStages - 2>();   // stage st has landed (this thread's)
    __syncthreads();                 // ... every thread's; slot st - 1 free
    issue(st + kTStages - 1);
    return ring + (st++ % kTStages) * kTSlot;
  };

  // rows wr + g (h = 0) and wr + g + 8 (h = 1) of the warp
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (p.stats_on_rows) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wr + g + 8 * h;
      if (row < p.rows) {
        lse_r[h] = lse[row];
        delta_r[h] = delta[row];
      }
    }
  }
  // acc[t][0..1]: row wr + g, columns w0 + 8 NT half + 8t + 2qd + {0, 1};
  // [2..3]: row + 8
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int s0 = 0; s0 < kTStages - 1; ++s0) issue(s0);
  for (int c0 = 0; c0 < p.cols; c0 += kTCols) {
    // the warp's 16 x 32 of s and dp: columns 32 half + 8t + 2qd + {0, 1}
    float s[4][4], dp[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
    for (int j = 0; j < n_s; ++j) tf32x3_chunk(s, next_slot(), wr, half);
    for (int j = 0; j < n_dp; ++j) tf32x3_chunk(dp, next_slot(), wr, half);

    // ---- X = p or ds, zero outside the valid rows and columns, into xs as
    // its TF32 halves. xs is free: the previous tile's m stages are behind
    // this tile's first barrier.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ct = 32 * half + 8 * t + 2 * qd;   // column in the tile
      float lse_c[2] = {0.f, 0.f}, delta_c[2] = {0.f, 0.f};
      if (!p.stats_on_rows) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c0 + ct + e < p.cols) {
            lse_c[e] = lse[c0 + ct + e];
            delta_c[e] = delta[c0 + ct + e];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = wr + g + 8 * h;             // row in the block
        float2 hi, lo;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = p.stats_on_rows ? lse_r[h] : lse_c[e];
          const float d = p.stats_on_rows ? delta_r[h] : delta_c[e];
          float x = 0.f;
          if (r0 + rt < p.rows && c0 + ct + e < p.cols) {
            x = expf(s[t][2 * h + e] * p.scale - l);
            if (part.ds) x *= (dp[t][2 * h + e] - d) * p.scale;
          }
          uint32_t xh, xl;
          split_tf32(x, xh, xl);
          (e ? hi.y : hi.x) = __uint_as_float(xh);
          (e ? lo.y : lo.x) = __uint_as_float(xl);
        }
        *reinterpret_cast<float2*>(xs_hi + rt * kTLdX + ct) = hi;
        *reinterpret_cast<float2*>(xs_lo + rt * kTLdX + ct) = lo;
      }
    }

    // ---- acc += X m, kKM rows of m a stage; X's A fragments come from xs
    // already split, m's B fragments are split here. Four 8-column tiles at
    // a time, whose stage sums start from zero and join acc by f32 adds.
    for (int j = 0; j < kMStages; ++j) {
      const float* slot = next_slot();   // also: every warp's X is in xs
      const float* ah = xs_hi + (wr + g) * kTLdX + j * kKM + 2 * qd;
      const float* al = xs_lo + (wr + g) * kTLdX + j * kKM + 2 * qd;
      const float* b = slot + 2 * qd * kLdM + 8 * NT * half + g;
#pragma unroll
      for (int t0 = 0; t0 < NT; t0 += 4) {
        if (t0 >= live) break;    // the warp's tiles past the output's width
        float partial[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kKM; kk += 8) {
          const float2 h0 = *reinterpret_cast<const float2*>(ah + kk);
          const float2 h1 =
              *reinterpret_cast<const float2*>(ah + 8 * kTLdX + kk);
          const float2 l0 = *reinterpret_cast<const float2*>(al + kk);
          const float2 l1 =
              *reinterpret_cast<const float2*>(al + 8 * kTLdX + kk);
          const uint32_t ahi[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                   __float_as_uint(h0.y), __float_as_uint(h1.y)};
          const uint32_t alo[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                   __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float* bt = b + kk * kLdM + 8 * (t0 + t);
            uint32_t bhi[2], blo[2];
            split_tf32(bt[0], bhi[0], blo[0]);
            split_tf32(bt[kLdM], bhi[1], blo[1]);
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

  // ---- epilogue
  float* out = part.out + (size_t)bi * p.rows * part.w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wr + g + 8 * h;
    if (row >= p.rows) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = w0 + 8 * NT * half + 8 * t + 2 * qd + e;
        if (col < part.w) out[(size_t)row * part.w + col] = acc[t][2 * h + e];
      }
  }
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int kBC = 64;         // columns per tile
constexpr int kBK = 64;         // channel chunk of s and dp
constexpr int kBW = 128;        // accumulator columns per block (grid.z)
constexpr int kLdM = kBW + 8;   // row stride of the m tile in shared memory
constexpr int kStages = 3;      // ring slots: one multiplied, two loading
constexpr int kSlot = 2 * 64 * kLd;   // bf16: a row and a column chunk
static_assert(kBC * kLdM <= kSlot, "the m tile fits one slot");
constexpr size_t kRingBytes = kStages * kSlot * sizeof(bf16);
constexpr size_t kMaxSmem = 232448 - 1024;   // a block's, less the static

int padded(int c) { return (c + kBK - 1) / kBK * kBK; }

// Shared memory of the resident variant: the ring, then the block's rows of
// ra and (for a dq or dk part) rb, each row padded to whole chunks + 8.
size_t resident_smem(int rows, int c, int cv, bool ds) {
  return kRingBytes + (size_t)rows * (padded(c) + 8) * sizeof(bf16) +
         (ds ? (size_t)rows * (padded(cv) + 8) * sizeof(bf16) : 0);
}

// c += the warp's 16 x 64 tile of a b^T over one kBK-channel chunk: a holds
// the block's rows (lda apart), b the tile's 64 columns (kLd apart).
__device__ __forceinline__ void chunk_product(float (&c)[kBC / 8][4],
                                              const bf16* a, int lda,
                                              const bf16* b) {
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (wr + (lane & 15)) * lda + kk + 8 * (lane >> 4));
#pragma unroll
    for (int t = 0; t < kBC / 8; t += 2) {
      uint32_t bf[4];   // b0, b1 of 8-column tiles t and t + 1
      ldsm_x4(bf, b + (t * 8 + (lane & 7) + 8 * (lane >> 4)) * kLd + kk +
                      8 * ((lane >> 3) & 1));
      mma_bf16(c[t], af, bf[0], bf[1]);
      mma_bf16(c[t + 1], af, bf[2], bf[3]);
    }
  }
}

// A block of WARPS warps owns 16 * WARPS rows and walks its column tiles as
// a sequence of stages, each one slot of the ring: the s chunks, the dp
// chunks (ds parts only), then the m tile (kBC x kBW, untransposed), whose
// stage turns s and dp into X and adds X m to the accumulator. RESIDENT:
// the block's rows of ra and rb are loaded once into shared memory and the
// s and dp stages bring only the column chunk; otherwise each stage brings
// both chunks.
template <int WARPS, bool RESIDENT>
__global__ void __launch_bounds__(32 * WARPS)
nonlocal_attention_bwd_bf16_kernel(const BwdParams<bf16> p) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kRows = 16 * WARPS;
  static_assert(RESIDENT || kRows + kBC <= 2 * 64, "both chunks fit a slot");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float lse_s[kBC], delta_s[kBC];      // per column (dk, dv)

  const int tid = threadIdx.x;
  const int wr = (tid >> 5) * 16;       // the warp's first row in the block
  const int lane = tid & 31;
  const int g = lane >> 2;              // fragment row (groupID)
  const int qd = lane & 3;              // fragment column pair
  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const bool first = (int)blockIdx.z < p.zsplit;
  const Part<bf16> part = first ? p.part0 : p.part1;
  const int w0 = ((int)blockIdx.z - (first ? 0 : p.zsplit)) * kBW;
  const int n_stats = p.stats_on_rows ? p.rows : p.cols;
  const bf16* ra = p.ra + (size_t)bi * p.rows * p.c;
  const bf16* ca = p.ca + (size_t)bi * p.cols * p.c;
  const bf16* rb = p.rb + (size_t)bi * p.rows * p.cv;
  const bf16* cb = p.cb + (size_t)bi * p.cols * p.cv;
  const float* lse = p.lse + (size_t)bi * n_stats;
  const float* delta = p.delta + (size_t)bi * n_stats;
  const bf16* m = part.m + (size_t)bi * p.cols * part.w;
  const bool vec_a = p.c % 8 == 0 && aligned16(p.ra) && aligned16(p.ca);
  const bool vec_b = p.cv % 8 == 0 && aligned16(p.rb) && aligned16(p.cb);
  const bool vec_m = part.w % 8 == 0 && aligned16(part.m);

  const int n_s = (p.c + kBK - 1) / kBK;
  const int n_dp = part.ds ? (p.cv + kBK - 1) / kBK : 0;
  const int per_tile = n_s + n_dp + 1;
  const int total = (p.cols + kBC - 1) / kBC * per_tile;
  // the resident rows: ra_s (kRows x lda), rb_s (kRows x ldb)
  const int lda = RESIDENT ? n_s * kBK + 8 : kLd;
  const int ldb = RESIDENT ? n_dp * kBK + 8 : kLd;
  bf16* ra_s = ring + kStages * kSlot;
  bf16* rb_s = ra_s + kRows * lda;

  // Start stage st's loads into its slot; one commit group per call, empty
  // past the end, so that the wait below counts stages.
  auto issue = [&](int st) {
    if (st < total) {
      bf16* slot = ring + (st % kStages) * kSlot;
      bf16* col_chunk = RESIDENT ? slot : slot + kRows * kLd;
      const int c0 = st / per_tile * kBC, j = st % per_tile;
      if (j < n_s) {
        if (!RESIDENT)
          load_tile_async<kRows, kBK, kThreads>(slot, kLd, ra, p.c, r0, p.rows,
                                                j * kBK, p.c, vec_a);
        load_tile_async<kBC, kBK, kThreads>(col_chunk, kLd, ca, p.c, c0,
                                            p.cols, j * kBK, p.c, vec_a);
      } else if (j < n_s + n_dp) {
        const int k0 = (j - n_s) * kBK;
        if (!RESIDENT)
          load_tile_async<kRows, kBK, kThreads>(slot, kLd, rb, p.cv, r0,
                                                p.rows, k0, p.cv, vec_b);
        load_tile_async<kBC, kBK, kThreads>(col_chunk, kLd, cb, p.cv, c0,
                                            p.cols, k0, p.cv, vec_b);
      } else {
        load_tile_async<kBC, kBW, kThreads>(slot, kLdM, m, part.w, c0, p.cols,
                                            w0, part.w, vec_m);
      }
    }
    cp_async_commit();
  };

  if (RESIDENT) {   // one group, older than every stage's
    for (int k0 = 0; k0 < n_s * kBK; k0 += kBK)
      load_tile_async<kRows, kBK, kThreads>(ra_s + k0, lda, ra, p.c, r0,
                                            p.rows, k0, p.c, vec_a);
    for (int k0 = 0; k0 < n_dp * kBK; k0 += kBK)
      load_tile_async<kRows, kBK, kThreads>(rb_s + k0, ldb, rb, p.cv, r0,
                                            p.rows, k0, p.cv, vec_b);
    cp_async_commit();
  }

  // rows wr + g (h = 0) and wr + g + 8 (h = 1) of the warp
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (p.stats_on_rows) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wr + g + 8 * h;
      if (row < p.rows) {
        lse_r[h] = lse[row];
        delta_r[h] = delta[row];
      }
    }
  }
  // acc[t][0..1]: row wr + g, cols w0 + 8t + 2qd + {0,1}; [2..3]: row + 8
  float acc[kBW / 8][4];
#pragma unroll
  for (int t = 0; t < kBW / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float s[kBC / 8][4], dp[kBC / 8][4];   // the warp's 16 x 64 of s and dp

  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int st = 0; st < total; ++st) {
    cp_async_wait<kStages - 2>();   // stage st has landed (this thread's part)
    __syncthreads();                // ... every thread's; slot st - 1 is free
    issue(st + kStages - 1);
    const bf16* slot = ring + (st % kStages) * kSlot;
    const bf16* col_chunk = RESIDENT ? slot : slot + kRows * kLd;
    const int c0 = st / per_tile * kBC, j = st % per_tile;
    if (j == 0) {
#pragma unroll
      for (int t = 0; t < kBC / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      // read in this tile's m stage, after at least one more barrier
      if (!p.stats_on_rows && tid < kBC) {
        const int col = c0 + tid;
        lse_s[tid] = col < p.cols ? lse[col] : 0.f;
        delta_s[tid] = col < p.cols ? delta[col] : 0.f;
      }
    }
    if (j < n_s) {
      if (RESIDENT)
        chunk_product(s, ra_s + j * kBK, lda, col_chunk);
      else
        chunk_product(s, slot, kLd, col_chunk);
    } else if (j < n_s + n_dp) {
      if (RESIDENT)
        chunk_product(dp, rb_s + (j - n_s) * kBK, ldb, col_chunk);
      else
        chunk_product(dp, slot, kLd, col_chunk);
    } else {
      // ---- X = p or ds, in place of s; zero outside the valid rows and
      // columns
#pragma unroll
      for (int t = 0; t < kBC / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int ct = t * 8 + 2 * qd + (e & 1);   // column in the tile
          const int row = r0 + wr + g + 8 * h, col = c0 + ct;
          const float l = p.stats_on_rows ? lse_r[h] : lse_s[ct];
          const float d = p.stats_on_rows ? delta_r[h] : delta_s[ct];
          float x = 0.f;
          if (row < p.rows && col < p.cols) {
            x = expf(s[t][e] * p.scale - l);
            if (part.ds) x *= (dp[t][e] - d) * p.scale;
          }
          s[t][e] = x;
        }
      // ---- acc += X m; the B fragments of m come transposed by ldmatrix
#pragma unroll
      for (int jj = 0; jj < kBC / 16; ++jj) {
        uint32_t af[4];
        c_to_a(af, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
        for (int t = 0; t < kBW / 8; t += 2) {
          uint32_t bf[4];   // b0, b1 of 8-column tiles t and t + 1
          ldsm_x4_trans(bf, slot + (jj * 16 + (lane & 7) +
                                    8 * ((lane >> 3) & 1)) * kLdM +
                                t * 8 + 8 * (lane >> 4));
          mma_bf16(acc[t], af, bf[0], bf[1]);
          mma_bf16(acc[t + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none in flight

  // ---- epilogue
  bf16* out = part.out + (size_t)bi * p.rows * part.w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wr + g + 8 * h;
    if (row >= p.rows) continue;
#pragma unroll
    for (int t = 0; t < kBW / 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = w0 + t * 8 + 2 * qd + e;
        if (col < part.w)
          out[(size_t)row * part.w + col] = __float2bfloat16(acc[t][2 * h + e]);
      }
  }
}

template <int WARPS, bool RESIDENT>
int launch_bf16(const BwdParams<bf16>& p, int b, int z_chunks, size_t smem,
                cudaStream_t stream) {
  auto kernel = nonlocal_attention_bwd_bf16_kernel<WARPS, RESIDENT>;
  // the ring alone is over the 48 KB of static shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRows = 16 * WARPS;
  const dim3 grid((p.rows + kRows - 1) / kRows, b, z_chunks);
  kernel<<<grid, 32 * WARPS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const BwdParams<float>& p, int b, int z_chunks,
           cudaStream_t stream) {
  const dim3 grid((p.rows + kFR - 1) / kFR, b, z_chunks);
  nonlocal_attention_bwd_f32_kernel<<<grid, kFThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// 128 rows with ra and rb resident where they fit (C, Cv <= 256 with both),
// else 64 rows streaming both chunks.
int launch(const BwdParams<bf16>& p, int b, int z_chunks,
           cudaStream_t stream) {
  const size_t smem = resident_smem(128, p.c, p.cv,
                                    p.part0.ds || p.part1.ds);
  if (smem <= kMaxSmem)
    return launch_bf16<8, true>(p, b, z_chunks, smem, stream);
  return launch_bf16<4, false>(p, b, z_chunks, kRingBytes, stream);
}

template <typename T>
int chunk_width();
template <>
int chunk_width<float>() { return kFW; }
template <>
int chunk_width<bf16>() { return kBW; }

int chunks(int w, int width) { return (w + width - 1) / width; }

// Sets p.zsplit for parts `width` columns a block: part 0's chunks, then
// (two_parts: K1-dkv) part 1's. Returns grid.z.
template <typename T>
int z_split(BwdParams<T>& p, int width, bool two_parts) {
  p.zsplit = chunks(p.part0.w, width);
  return p.zsplit + (two_parts ? chunks(p.part1.w, width) : 0);
}

// K1-dq: rows = queries, cols = keys, one part: dq += ds k.
template <typename T>
BwdParams<T> dq_params(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int n, int nk, int c, int cv, float scale) {
  BwdParams<T> p;
  p.ra = static_cast<const T*>(q);
  p.ca = static_cast<const T*>(k);
  p.rb = static_cast<const T*>(dout);
  p.cb = static_cast<const T*>(v);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.rows = n;
  p.cols = nk;
  p.c = c;
  p.cv = cv;
  p.scale = scale;
  p.stats_on_rows = 1;
  p.part0 = Part<T>{static_cast<const T*>(k), static_cast<T*>(dq), c, 1};
  p.part1 = p.part0;
  return p;
}

// K1-dkv: rows = keys, cols = queries; part 0 makes dk += ds^T q, part 1
// dv += p^T do.
template <typename T>
BwdParams<T> dkv_params(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int n, int nk, int c, int cv,
                        float scale) {
  BwdParams<T> p;
  p.ra = static_cast<const T*>(k);
  p.ca = static_cast<const T*>(q);
  p.rb = static_cast<const T*>(v);
  p.cb = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.rows = nk;
  p.cols = n;
  p.c = c;
  p.cv = cv;
  p.scale = scale;
  p.stats_on_rows = 0;
  p.part0 = Part<T>{static_cast<const T*>(q), static_cast<T*>(dk), c, 1};
  p.part1 = Part<T>{static_cast<const T*>(dout), static_cast<T*>(dv), cv, 0};
  return p;
}

template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int n, int nk,
           int c, int cv, float scale, cudaStream_t stream) {
  BwdParams<T> p = dq_params<T>(q, k, v, dout, lse, delta, dq, n, nk, c, cv,
                                scale);
  return launch(p, b, z_split(p, chunk_width<T>(), false), stream);
}

template <typename T>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int n, int nk, int c, int cv, float scale, cudaStream_t stream) {
  BwdParams<T> p = dkv_params<T>(q, k, v, dout, lse, delta, dk, dv, n, nk, c,
                                 cv, scale);
  return launch(p, b, z_split(p, chunk_width<T>(), true), stream);
}

// ------------------------------------------------- tf32x3: launch
template <int NT>
int launch_tf32x3_nt(const BwdParams<float>& p, int b, int z,
                     cudaStream_t stream) {
  auto kernel = nonlocal_attention_bwd_tf32x3_kernel<NT>;
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, kTSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.rows + kTRows - 1) / kTRows, b, z);
  kernel<<<grid, kTThreads, kTSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The program instantiated for the narrowest accumulator that holds the
// widest part (8-column tiles a warp, half of a block's 16 NT columns),
// and kTMaxNT past 16 kTMaxNT columns, which then go over grid.z.
int launch_tf32x3(BwdParams<float>& p, int b, bool two_parts,
                  cudaStream_t stream) {
  const int w = two_parts && p.part1.w > p.part0.w ? p.part1.w : p.part0.w;
  const int want = (w + 15) / 16;
  const int kNT[] = {4, 8, 16, 24};
  int nt = kTMaxNT;
  for (int t : kNT)
    if (want <= t && t < nt) nt = t;
  const int z = z_split(p, 16 * nt, two_parts);
  switch (nt) {
    case 4: return launch_tf32x3_nt<4>(p, b, z, stream);
    case 8: return launch_tf32x3_nt<8>(p, b, z, stream);
    case 16: return launch_tf32x3_nt<16>(p, b, z, stream);
    case 24: return launch_tf32x3_nt<24>(p, b, z, stream);
    default: return launch_tf32x3_nt<kTMaxNT>(p, b, z, stream);
  }
}

// ---------------------------------------- bf16, Hopper: wgmma, TMA, ring
// K1-dkv where C and Cv are multiples of 64 up to 256 (the dispatch in
// ops/cuda/nonlocal_attention.py; the train layer-2 shape). A block owns
// (batch item, 64 keys). Warpgroup 2 produces (one thread issues every TMA
// copy); warpgroup 0 accumulates dv (64 x Cv f32), warpgroup 1 dk (64 x C
// f32), 128 registers a thread each. Shared memory, each tile a stack of
// swizzled 64-channel chunks (wgmma_tiles.cuh):
//   k, v     the block's 64 keys, loaded once     (128 (C + Cv) bytes)
//   q ring   2 slots of 64 queries x C            (256 C bytes)
//   do ring  2 slots of 64 queries x Cv           (256 Cv bytes)
//   p^T      2 slots of 64 x 64 f32                (32 KB)
// 224 KB at C = Cv = 256. Per query tile:
//   dv group: s^T = k q^T (64 keys x 64 queries, both operands in shared
//     memory), p^T = exp(s^T scale - lse) in registers, handed to the dk
//     group through shared memory (f32, in accumulator order, so each
//     thread reads back exactly its own fragment: no bank conflicts), then
//     dv += p^T do (A = p^T from registers, B = do MN-major);
//   dk group: dp^T = v do^T, ds^T = p^T (dp^T - delta) scale in registers,
//     dk += ds^T q (A from registers, B = q MN-major).
// s^T is formed once, so each product runs once: 1.0x the minimal FLOPs,
// against 2.6x for the generic program's 128-column chunks. The two groups
// do equal work (C = Cv). No atomics: the gradient is the same every run.
constexpr int kDkvPBytes = 32 * 128 * 4;   // one p^T slot

size_t dkv_wgmma_smem(int c, int cv) {
  return 384 * (size_t)(c + cv) + 2 * kDkvPBytes + 2 * sizeof(Ring<2>) +
         sizeof(uint64_t) + 1024;   // + 1024: aligning the base
}

__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap dkmap,
    const __grid_constant__ CUtensorMap dvmap, const float* __restrict__ lse,
    const float* __restrict__ delta, int n, int nk, int c, int cv,
    float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + 128 * c;
  unsigned char* qr = vs + 128 * cv;       // the q ring, then the do ring
  unsigned char* dor = qr + 256 * c;
  float* pbuf = reinterpret_cast<float*>(dor + 256 * cv);
  Ring<2>* qring = reinterpret_cast<Ring<2>*>(
      reinterpret_cast<unsigned char*>(pbuf) + 2 * kDkvPBytes);
  Ring<2>* doring = qring + 1;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(doring + 1);

  const int nc = c / 64, nv = cv / 64;
  const int bi = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int tiles = (n + 63) / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    qring->init(kWConsumerWarps);
    doring->init(kWConsumerWarps);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: k and v once, then q and do tiles through the rings
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kvbar, 64 * (c + cv) * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(ks + j * 8192, &kmap, kvbar, 64 * j, k0, bi);
      for (int j = 0; j < nv; ++j)
        tma_load(vs + j * 8192, &vmap, kvbar, 64 * j, k0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<2>::slot(t);
        qring->wait_empty(t);
        mbar_expect_tx(&qring->full[s], 64 * c * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(qr + s * 128 * c + j * 8192, &qmap, &qring->full[s],
                   64 * j, 64 * t, bi);
        doring->wait_empty(t);
        mbar_expect_tx(&doring->full[s], 64 * cv * 2);
        for (int j = 0; j < nv; ++j)
          tma_load(dor + s * 128 * cv + j * 8192, &domap, &doring->full[s],
                   64 * j, 64 * t, bi);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const float sl2 = scale * kLog2e;
    const float* lse_b = lse + (size_t)bi * n;
    const float* delta_b = delta + (size_t)bi * n;

    float acc[4][32];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    // Named barriers: 1 + b "p^T slot b written", 3 + b "slot b read", over
    // both consumer groups (256 threads).
    mbar_wait(kvbar, 0);
    if (wg == 0) {
      // ---- dv += p^T do
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<2>::slot(t), b = t & 1;
        // this thread's 16 query columns: 8 (i / 4) + 2 qd + i % 2
        float lcol[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int col = 64 * t + 8 * (e >> 1) + 2 * qd + (e & 1);
          lcol[e] = col < n ? lse_b[col] * kLog2e : 0.f;
        }
        float st[32];
        qring->wait_full(t);
        wgmma_fence();
        ss_scores(st, smem_addr(ks), 8192, smem_addr(qr) + s * 128 * c, nc);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        qring->release(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int e = 2 * (i >> 2) + (i & 1);
          const int col = 64 * t + 8 * (i >> 2) + 2 * qd + (i & 1);
          st[i] = col < n ? exp2f(st[i] * sl2 - lcol[e]) : 0.f;
        }
        named_sync(3 + b, 256);
        float* pb = pbuf + b * 32 * 128;
#pragma unroll
        for (int i = 0; i < 32; ++i) pb[i * 128 + tid] = st[i];
        named_arrive(1 + b, 256);
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_to_a(pa[j], st, j);
        doring->wait_full(t);
        const uint32_t dt = smem_addr(dor) + s * 128 * cv;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rs_product(acc, pa[kk], dt + kk * 16 * 128, nv);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          reg_fence(acc[j]);
          reg_fence(pa[j]);
        }
        doring->release(t);
      }
    } else {
      // ---- dk += ds^T q; both p^T slots start free
      named_arrive(3, 256);
      if (tiles > 1) named_arrive(4, 256);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<2>::slot(t), b = t & 1;
        float dcol[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int col = 64 * t + 8 * (e >> 1) + 2 * qd + (e & 1);
          dcol[e] = col < n ? delta_b[col] : 0.f;
        }
        float dp[32];
        doring->wait_full(t);
        wgmma_fence();
        ss_scores(dp, smem_addr(vs), 8192, smem_addr(dor) + s * 128 * cv, nv);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dp);
        doring->release(t);
        named_sync(1 + b, 256);
        const float* pb = pbuf + b * 32 * 128;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = pb[i * 128 + tid] * (dp[i] - dcol[2 * (i >> 2) + (i & 1)]) *
                  scale;
        if (t + 2 < tiles) named_arrive(3 + b, 256);
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_to_a(pa[j], dp, j);
        qring->wait_full(t);
        const uint32_t qt = smem_addr(qr) + s * 128 * c;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rs_product(acc, pa[kk], qt + kk * 16 * 128, nc);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          reg_fence(acc[j]);
          reg_fence(pa[j]);
        }
        qring->release(t);
      }
    }

    // ---- epilogue: dv (group 0) and dk (group 1) in bf16 through the
    // rings (free once both groups are past their last product), one TMA
    // store per 64-column chunk; keys past nk are clipped by the store
    named_sync(5, 256);
    unsigned char* stage = qr + (wg == 0 ? 0 : 128 * cv);
    const int nw = wg == 0 ? nv : nc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nw) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp * 16 + g + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(
            stage + j * 8192 + swizzled_pair(r, 8 * (i >> 2) + 2 * qd)) =
            pack_pair(acc[j][i], acc[j][i + 1]);
      }
    }
    fence_proxy_async();
    named_sync(6 + wg, 128);
    if (tid == 0) {
      for (int j = 0; j < nw; ++j)
        tma_store(wg == 0 ? &dvmap : &dkmap, stage + j * 8192, 64 * j, k0, bi);
      tma_store_drain();
    }
  }
}

// ---------------------------------------- bf16, Hopper: K1-dq on wgmma
// Replaces `_attn_dq_kernel` (pretorched_tpu/ops/pallas/
// nonlocal_attention.py:141) where C and Cv are multiples of 64 up to 256
// (the same dispatch as K1-fwd and K1-dkv; the train layer-2 shape and
// sub_sample).
//
// What bounds it: operations. At (B, N, Nk, C, Cv) = (8, 6272, 6272, 256,
// 256) dq needs 2 B N Nk (2C + Cv) = 483 GFLOP, 0.49 ms at the bf16 peak,
// against 0.18 ms for its bytes. The generic program splits dq's 256
// columns into two grid chunks, each forming s and dp again (1.67x the
// products), on mma.sync.
//
// Design. A block owns (batch item, 64 queries); q, do, lse and delta of
// the band stay resident, k and v stream through 2-slot TMA rings.
// Warpgroup 2 produces (one thread issues every TMA copy); per key tile:
//   group 0: s = q k^T (SS, k K-major), p = exp(s scale - lse), zero at
//     keys past Nk, handed to group 1 in shared memory (f32, accumulator
//     order: each thread reads back only its own words, no bank conflicts);
//   group 1: dp = do v^T (SS, v K-major), ds = p (dp - delta) scale, rounded
//     to bf16 as the A fragments of the next product and handed back in the
//     same words;
//   both: dq[:, half] += ds k[:, half] (A = ds from registers, B = k
//     MN-major): group 0 takes dq's first ceil(C / 128) 64-column chunks,
//     group 1 the rest, 64 x 128 f32 (64 registers a thread) each at C =
//     256.
// s and dp run side by side on the two groups, then the two halves of dq:
// every product once (1.0x the minimal work) and equal work per group. One
// exchange slot suffices: group 0 writes p of tile t + 1 only after reading
// ds of tile t, and group 1 writes ds only after reading p.
// Shared memory at C = Cv = 256 (each tile a stack of swizzled 64-channel
// chunks, wgmma_tiles.cuh): q and do 32 KB each, the k and v rings 64 KB
// each, the exchange slot 16 KB: 208 KB, plus barriers and 1 KB of
// alignment. ptxas on the H100 build: 168 registers at entry, no spills;
// `setmaxnreg` gives the consumers 240 and the producer 24 (chip_smoke.py's
// phase 2 prints the report). No atomics: dq is the same every run.
constexpr int kDqXBytes = 32 * 128 * 4;   // the p / ds exchange slot

size_t dq_wgmma_smem(int c, int cv) {
  return 384 * (size_t)(c + cv) + kDqXBytes + 2 * sizeof(Ring<2>) +
         sizeof(uint64_t) + 1024;   // + 1024: aligning the base
}

__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
    const float* __restrict__ delta, int n, int nk, int c, int cv,
    float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + 128 * c;
  unsigned char* kr = dos + 128 * cv;      // the k ring, then the v ring
  unsigned char* vr = kr + 256 * c;
  float* xbuf = reinterpret_cast<float*>(vr + 256 * cv);
  Ring<2>* kring = reinterpret_cast<Ring<2>*>(
      reinterpret_cast<unsigned char*>(xbuf) + kDqXBytes);
  Ring<2>* vring = kring + 1;
  uint64_t* rowbar = reinterpret_cast<uint64_t*>(vring + 1);

  const int nc = c / 64, nv = cv / 64;
  const int half0 = (nc + 1) / 2;          // dq chunks of group 0
  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tiles = (nk + 63) / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    kring->init(kWConsumerWarps);          // both groups read k
    vring->init(kWConsumerWarps / 2);      // group 1 alone reads v
    mbar_init(rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: q and do once, then k and v tiles through the rings
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(rowbar, 64 * (c + cv) * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(qs + j * 8192, &qmap, rowbar, 64 * j, q0, bi);
      for (int j = 0; j < nv; ++j)
        tma_load(dos + j * 8192, &domap, rowbar, 64 * j, q0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<2>::slot(t);
        kring->wait_empty(t);
        mbar_expect_tx(&kring->full[s], 64 * c * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(kr + s * 128 * c + j * 8192, &kmap, &kring->full[s],
                   64 * j, 64 * t, bi);
        vring->wait_empty(t);
        mbar_expect_tx(&vring->full[s], 64 * cv * 2);
        for (int j = 0; j < nv; ++j)
          tma_load(vr + s * 128 * cv + j * 8192, &vmap, &vring->full[s],
                   64 * j, 64 * t, bi);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const float sl2 = scale * kLog2e;
    // this thread's rows warp * 16 + g + 8 h: lse (in log2 units) for group
    // 0, delta for group 1
    float rowstat[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + 8 * h;
      const float* stat = wg == 0 ? lse : delta;
      rowstat[h] = row < n ? stat[(size_t)bi * n + row] : 0.f;
      if (wg == 0) rowstat[h] *= kLog2e;
    }
    // dq chunks [j0, j0 + nw) of this group
    const int j0 = wg == 0 ? 0 : half0;
    const int nw = wg == 0 ? half0 : nc - half0;
    uint32_t* xwords = reinterpret_cast<uint32_t*>(xbuf);

    float acc[2][32];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    // Named barriers over both groups (256 threads): 1 "p written", 2 "ds
    // written".
    mbar_wait(rowbar, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = Ring<2>::slot(t);
      uint32_t pa[4][4];
      if (wg == 0) {
        // ---- s = q k^T, p
        float st[32];
        kring->wait_full(t);
        wgmma_fence();
        ss_scores(st, smem_addr(qs), 8192, smem_addr(kr) + s * 128 * c, nc);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 64 * t + 8 * (i >> 2) + 2 * qd + (i & 1);
          xbuf[i * 128 + tid] =
              col < nk ? exp2f(st[i] * sl2 - rowstat[(i >> 1) & 1]) : 0.f;
        }
        named_arrive(1, 256);
        named_sync(2, 256);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[j][e] = xwords[(4 * j + e) * 128 + tid];
      } else {
        // ---- dp = do v^T, ds
        float dp[32];
        vring->wait_full(t);
        wgmma_fence();
        ss_scores(dp, smem_addr(dos), 8192, smem_addr(vr) + s * 128 * cv, nv);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dp);
        vring->release(t);
        named_sync(1, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = xbuf[i * 128 + tid] * (dp[i] - rowstat[(i >> 1) & 1]) *
                  scale;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_to_a(pa[j], dp, j);
#pragma unroll
          for (int e = 0; e < 4; ++e) xwords[(4 * j + e) * 128 + tid] = pa[j][e];
        }
        named_arrive(2, 256);
        kring->wait_full(t);
      }
      // ---- dq[:, this group's chunks] += ds k. Both products are issued
      // whatever nw is: a branch around a wgmma makes ptxas serialize the
      // warpgroup's wgmmas (C7520), which cost 25% at layer 2 (PERF.md).
      // Past nw the product rereads chunk j0 into an accumulator that is
      // never stored.
      const uint32_t kt = smem_addr(kr) + s * 128 * c + j0 * 8192;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wgmma_rs_n64(acc[j], pa[kk],
                       wgmma_desc(kt + kk * 16 * 128 + (j < nw ? j : 0) * 8192,
                                  0, 1024),
                       1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 4; ++j) reg_fence(pa[j]);
#pragma unroll
      for (int j = 0; j < 2; ++j) reg_fence(acc[j]);
      kring->release(t);
    }

    // ---- epilogue: dq in bf16, staged swizzled over q (free once group
    // 0's last s is done), one TMA store per 64-column chunk; rows past n
    // are clipped by the store
    named_sync(3, 256);
    unsigned char* stage = qs + j0 * 8192;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nw) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp * 16 + g + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(
            stage + j * 8192 + swizzled_pair(r, 8 * (i >> 2) + 2 * qd)) =
            pack_pair(acc[j][i], acc[j][i + 1]);
      }
    }
    fence_proxy_async();
    named_sync(4 + wg, 128);
    if (tid == 0 && nw > 0) {
      for (int j = 0; j < nw; ++j)
        tma_store(&dqmap, stage + j * 8192, 64 * (j0 + j), q0, bi);
      tma_store_drain();
    }
  }
}

int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int b, int n, int nk, int c, int cv, float scale,
                    cudaStream_t stream) {
  if (c % 64 || cv % 64 || c > 256 || cv > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom, dqm;
  if (!make_map(&qm, q, b, n, c, 64) || !make_map(&km, k, b, nk, c, 64) ||
      !make_map(&vm, v, b, nk, cv, 64) || !make_map(&dom, dout, b, n, cv, 64) ||
      !make_map(&dqm, dq, b, n, c, 64))
    return (int)cudaErrorNotSupported;
  const size_t smem = dq_wgmma_smem(c, cv);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem(nonlocal_attention_bwd_dq_wgmma_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 63) / 64, b);
  nonlocal_attention_bwd_dq_wgmma_kernel<<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, dom, dqm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), n, nk, c, cv, scale);
  return (int)cudaGetLastError();
}

int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int b, int n, int nk, int c, int cv,
                     float scale, cudaStream_t stream) {
  if (c % 64 || cv % 64 || c > 256 || cv > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom, dkm, dvm;
  if (!make_map(&qm, q, b, n, c, 64) || !make_map(&km, k, b, nk, c, 64) ||
      !make_map(&vm, v, b, nk, cv, 64) || !make_map(&dom, dout, b, n, cv, 64) ||
      !make_map(&dkm, dk, b, nk, c, 64) || !make_map(&dvm, dv, b, nk, cv, 64))
    return (int)cudaErrorNotSupported;
  const size_t smem = dkv_wgmma_smem(c, cv);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem(nonlocal_attention_bwd_dkv_wgmma_kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nk + 63) / 64, b);
  nonlocal_attention_bwd_dkv_wgmma_kernel<<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, dom, dkm, dvm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), n, nk, c, cv, scale);
  return (int)cudaGetLastError();
}

// ------------------------------- bf16, Hopper: the wide K1-dkv (layer 3)
// C and Cv multiples of 64 up to 512, one of them above 256 (the dispatch
// in ops/cuda/nonlocal_attention.py; the train step's layer 3, (B, N, Nk,
// C, Cv) = (8, 784, 784, 512, 512)).
//
// What bounds it: operations. dk and dv need 2 B N Nk (2C + 2Cv) = 20.1
// GFLOP there, 0.0204 ms at the bf16 peak. The kernel above cannot take the
// width: dk and dv of 64 keys would be 2 x 64 x 512 f32, 256 KB, the
// whole register file of an SM.
//
// Design. A block owns (64 keys, batch item, column half h): grid
// (ceil(Nk / 64), B, 2). With W = max(ceil(C / 128), ceil(Cv / 128))
// 64-column chunks a half, consumer warpgroup 0 accumulates dv[:, 64 W h ..
// 64 W h + 64 W) and consumer 1 dk[:, the same columns], 64 x 256 f32 (128
// registers a thread) each at C = Cv = 512; warpgroup 2 produces (one
// thread issues every TMA copy). The block's k and v rows stay resident;
// q and do stream through rings of kDkvWideTq queries. Per query tile:
//   consumer 0: s^T = k q^T over all of C (SS), p^T = exp(s^T scale -
//     lse), zero at queries past N, handed to consumer 1 through one of
//     two shared slots (f32, in accumulator order: each thread reads back
//     only its own words); then dv += p^T do[:, half] (A = p^T from
//     registers, B = do MN-major);
//   consumer 1: dp^T = v do^T over all of Cv (SS), ds^T = p^T (dp^T -
//     delta) scale, then dk += ds^T q[:, half].
// s^T and dp^T are formed once per half, so over the two halves the
// products are 1.5x the minimal ones at C = Cv, against 3.5x at 512 for
// the generic program's 128-column z-chunks (each of the 8 forms s again,
// and each dk chunk dp). No atomics: dk and dv are the same every run. Each
// product reads W chunks of its slot whether or not they all exist (a
// slot holds 2W chunks), so no branch guards a wgmma.
// Shared memory, each tile a stack of swizzled 64-channel chunks
// (wgmma_tiles.cuh): k and v 64 KB each, the q and do rings one slot of
// 32 queries x 2W chunks each (32 KB each), the two p^T slots 16 KB: 208
// KB at C = Cv = 512, plus barriers and 1 KB of alignment. Against a 2-slot
// ring of 16 queries (the same bytes): s^T and dp^T at N = 16 read their
// A operand (k, v: 2 KB a k-step) for 8 clocks of products and wait on
// shared memory 2.5x; at N = 32, 1.5x. `tools/port_kernel_probes.py wide`
// times both (PERF.md: one slot of 32 is the faster).
constexpr int kDkvWideTq = 32;      // queries per ring slot
constexpr int kDkvWideStages = 1;   // ring slots
static_assert(kDkvWideTq * kDkvWideStages >= 32,
              "dk and dv are staged in the q and do rings: 64 rows x 2W "
              "chunks");

template <int W>
size_t dkv_wide_smem(int c, int cv) {
  return 128 * (size_t)(c + cv) +
         2 * (size_t)kDkvWideStages * (2 * W * kDkvWideTq * 128) +
         2 * (kDkvWideTq / 2 * 128 * 4) +
         2 * sizeof(Ring<kDkvWideStages>) + sizeof(uint64_t) +
         1024;   // + 1024: aligning the base
}

template <int W>
__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_bwd_dkv_wide_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap dkmap,
    const __grid_constant__ CUtensorMap dvmap, const float* __restrict__ lse,
    const float* __restrict__ delta, int n, int nk, int c, int cv,
    float scale) {
  constexpr int TQ = kDkvWideTq, ST = kDkvWideStages;
  constexpr int kSlot = 2 * W * TQ * 128;     // one q or do slot
  constexpr int kPWords = TQ / 2 * 128;       // one p^T slot, f32
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + 128 * c;
  unsigned char* qr = vs + 128 * cv;       // the q ring, then the do ring
  unsigned char* dor = qr + ST * kSlot;
  float* pbuf = reinterpret_cast<float*>(dor + ST * kSlot);
  Ring<ST>* qring = reinterpret_cast<Ring<ST>*>(pbuf + 2 * kPWords);
  Ring<ST>* doring = qring + 1;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(doring + 1);

  const int nc = c / 64, nv = cv / 64;
  const int bi = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int j0 = blockIdx.z * W;           // the half's first chunk
  const int tiles = (n + TQ - 1) / TQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    qring->init(kWConsumerWarps);
    doring->init(kWConsumerWarps);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: k and v once, then q and do tiles through the rings
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kvbar, 64 * (c + cv) * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(ks + j * 8192, &kmap, kvbar, 64 * j, k0, bi);
      for (int j = 0; j < nv; ++j)
        tma_load(vs + j * 8192, &vmap, kvbar, 64 * j, k0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<ST>::slot(t);
        qring->wait_empty(t);
        mbar_expect_tx(&qring->full[s], TQ * c * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(qr + s * kSlot + j * TQ * 128, &qmap, &qring->full[s],
                   64 * j, TQ * t, bi);
        doring->wait_empty(t);
        mbar_expect_tx(&doring->full[s], TQ * cv * 2);
        for (int j = 0; j < nv; ++j)
          tma_load(dor + s * kSlot + j * TQ * 128, &domap, &doring->full[s],
                   64 * j, TQ * t, bi);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const float sl2 = scale * kLog2e;
    const float* lse_b = lse + (size_t)bi * n;
    const float* delta_b = delta + (size_t)bi * n;

    float acc[W][32];
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    // Named barriers: 1 + b "p^T slot b written", 3 + b "slot b read", over
    // both consumers (256 threads).
    mbar_wait(kvbar, 0);
    if (wg == 0) {
      // ---- dv[:, half] += p^T do[:, half]
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<ST>::slot(t), b = t & 1;
        // this thread's TQ / 4 query columns: 8 (e / 2) + 2 qd + e % 2
        float lcol[TQ / 4];
#pragma unroll
        for (int e = 0; e < TQ / 4; ++e) {
          const int col = TQ * t + 8 * (e >> 1) + 2 * qd + (e & 1);
          lcol[e] = col < n ? lse_b[col] * kLog2e : 0.f;
        }
        // zeroed and pinned before the products: left undefined, ptxas
        // defines them inside the wgmma pipeline stage and serializes every
        // product of the kernel (C7515), 28% slower (PERF.md)
        float st[TQ / 2] = {};
        reg_fence(st);
        qring->wait_full(t);
        wgmma_fence();
        ss_scores(st, smem_addr(ks), 8192, smem_addr(qr) + s * kSlot, nc,
                  TQ * 128);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        qring->release(t);
#pragma unroll
        for (int i = 0; i < TQ / 2; ++i) {
          const int e = 2 * (i >> 2) + (i & 1);
          const int col = TQ * t + 8 * (i >> 2) + 2 * qd + (i & 1);
          st[i] = col < n ? exp2f(st[i] * sl2 - lcol[e]) : 0.f;
        }
        named_sync(3 + b, 256);
        float* pb = pbuf + b * kPWords;
#pragma unroll
        for (int i = 0; i < TQ / 2; ++i) pb[i * 128 + tid] = st[i];
        named_arrive(1 + b, 256);
        uint32_t pa[TQ / 16][4];
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j) acc_to_a(pa[j], st, j);
        doring->wait_full(t);
        const uint32_t dt = smem_addr(dor) + s * kSlot + j0 * TQ * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
          rs_chunks(acc, pa[kk], dt + kk * 16 * 128, TQ * 128);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < W; ++j) reg_fence(acc[j]);
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j) reg_fence(pa[j]);
        doring->release(t);
      }
    } else {
      // ---- dk[:, half] += ds^T q[:, half]; both p^T slots start free
      named_arrive(3, 256);
      if (tiles > 1) named_arrive(4, 256);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<ST>::slot(t), b = t & 1;
        float dcol[TQ / 4];
#pragma unroll
        for (int e = 0; e < TQ / 4; ++e) {
          const int col = TQ * t + 8 * (e >> 1) + 2 * qd + (e & 1);
          dcol[e] = col < n ? delta_b[col] : 0.f;
        }
        float dp[TQ / 2] = {};   // as st above
        reg_fence(dp);
        doring->wait_full(t);
        wgmma_fence();
        ss_scores(dp, smem_addr(vs), 8192, smem_addr(dor) + s * kSlot, nv,
                  TQ * 128);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dp);
        doring->release(t);
        named_sync(1 + b, 256);
        const float* pb = pbuf + b * kPWords;
#pragma unroll
        for (int i = 0; i < TQ / 2; ++i)
          dp[i] = pb[i * 128 + tid] * (dp[i] - dcol[2 * (i >> 2) + (i & 1)]) *
                  scale;
        if (t + 2 < tiles) named_arrive(3 + b, 256);
        uint32_t pa[TQ / 16][4];
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j) acc_to_a(pa[j], dp, j);
        qring->wait_full(t);
        const uint32_t qt = smem_addr(qr) + s * kSlot + j0 * TQ * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk)
          rs_chunks(acc, pa[kk], qt + kk * 16 * 128, TQ * 128);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < W; ++j) reg_fence(acc[j]);
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j) reg_fence(pa[j]);
        qring->release(t);
      }
    }

    // ---- epilogue: dv (consumer 0) and dk (consumer 1) of this half in
    // bf16, staged in the rings (free once both are past their last
    // product), one TMA store per existing 64-column chunk; keys past nk
    // are clipped by the store
    named_sync(5, 256);
    unsigned char* stage = qr + wg * W * 8192;
    const int nw = wg == 0 ? nv : nc;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j0 + j >= nw) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp * 16 + g + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(
            stage + j * 8192 + swizzled_pair(r, 8 * (i >> 2) + 2 * qd)) =
            pack_pair(acc[j][i], acc[j][i + 1]);
      }
    }
    fence_proxy_async();
    named_sync(6 + wg, 128);
    if (tid == 0) {
      for (int j = 0; j < W && j0 + j < nw; ++j)
        tma_store(wg == 0 ? &dvmap : &dkmap, stage + j * 8192, 64 * (j0 + j),
                  k0, bi);
      tma_store_drain();
    }
  }
}

template <int W>
int launch_dkv_wide(const CUtensorMap (&maps)[6], const void* lse,
                    const void* delta, int b, int n, int nk, int c, int cv,
                    float scale, cudaStream_t stream) {
  const size_t smem = dkv_wide_smem<W>(c, cv);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(nonlocal_attention_bwd_dkv_wide_kernel<W>,
                                     smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nk + 63) / 64, b, 2);
  nonlocal_attention_bwd_dkv_wide_kernel<W><<<grid, kWThreads, smem,
                                              stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const float*>(lse), static_cast<const float*>(delta), n,
      nk, c, cv, scale);
  return (int)cudaGetLastError();
}

int launch_dkv_wgmma_wide(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int b, int n,
                          int nk, int c, int cv, float scale,
                          cudaStream_t stream) {
  if (c % 64 || cv % 64 || c > 512 || cv > 512 || (c <= 256 && cv <= 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];   // q, k, v, do, dk, dv
  if (!make_map(&maps[0], q, b, n, c, kDkvWideTq) ||
      !make_map(&maps[1], k, b, nk, c, 64) ||
      !make_map(&maps[2], v, b, nk, cv, 64) ||
      !make_map(&maps[3], dout, b, n, cv, kDkvWideTq) ||
      !make_map(&maps[4], dk, b, nk, c, 64) ||
      !make_map(&maps[5], dv, b, nk, cv, 64))
    return (int)cudaErrorNotSupported;
  // one above 256, so the half is 3 or 4 chunks
  const int w = (c > cv ? c : cv) / 64;
  if ((w + 1) / 2 == 3)
    return launch_dkv_wide<3>(maps, lse, delta, b, n, nk, c, cv, scale,
                              stream);
  return launch_dkv_wide<4>(maps, lse, delta, b, n, nk, c, cv, scale, stream);
}

// -------------------------------- bf16, Hopper: the wide K1-dq (layer 3)
// Replaces `_attn_dq_kernel` (pretorched_tpu/ops/pallas/
// nonlocal_attention.py:141) where C and Cv are multiples of 64 up to 512,
// one of them above 256 (the dispatch in ops/cuda/nonlocal_attention.py;
// the train step's layer 3, (B, N, Nk, C, Cv) = (8, 784, 784, 512, 512)).
//
// What bounds it: operations. dq needs 2 B N Nk (2C + Cv) = 15.1 GFLOP
// there, 0.0153 ms at the bf16 peak. The kernel above cannot take the
// width: its q and do stay resident beside 2-slot rings of 64 keys, 384 (C
// + Cv) bytes, 384 KB at 512.
//
// Design. A block owns (64 queries, batch item): grid (ceil(N / 64), B).
// q and do of the band stay resident; k and v stream through one-slot
// rings of kDqWideTk keys. Warpgroup 2 produces: one thread loads q, do and
// the k ring, another the v ring, so v's next tile is not held behind k's
// slot, which frees only after the dq product. Per key tile, the exchange
// of the kernel above:
//   consumer 0: s = q k^T over all of C (SS), p = exp(s scale - lse), zero
//     at keys past Nk, handed to consumer 1 in the exchange slot (f32, in
//     accumulator order: each thread reads back only its own words);
//   consumer 1: dp = do v^T over all of Cv (SS), ds = p (dp - delta)
//     scale, rounded to bf16 as A fragments and handed back in the same
//     words;
//   consumer g: dq[:, 64 W g .. 64 W g + 64 W) += ds k[:, the same columns]
//     (A = ds from registers, B = k MN-major), with W = ceil(C / 128) a
//     template argument: acc[W][32], 128 registers a thread at C = 512.
// Every product once (1.0x the minimal ones, against 3x for the generic
// program's four 128-column z-chunks at 512). No atomics: dq is the same
// every run. A k slot holds 2W chunks and each dq product reads W of them
// whether or not they all exist (C = 320: 5 of 6; C = 64: consumer 1 owns
// none), into accumulators that are never stored, so no branch guards a
// wgmma (C7520).
// Shared memory at C = Cv = 512, each tile a stack of swizzled 64-channel
// chunks (wgmma_tiles.cuh): q and do 64 KB each, the k and v slots of 32
// keys 32 KB each, the exchange slot 8 KB: 200 KB, plus barriers and 1 KB
// of alignment. Slots of 64 keys would take 256 KB beside q and do. s and
// dp are m64n32k16 products, which wait on shared memory for their A
// operand (q, do: 2 KB a k-step) 1.5x as long as they multiply; against
// two slots of 16 keys (the same bytes, 2.5x)
// `tools/port_kernel_probes.py wide` times both (PERF.md).
constexpr int kDqWideTk = 32;       // keys per ring slot
constexpr int kDqWideStages = 1;    // ring slots

template <int W>
size_t dq_wide_smem(int c, int cv) {
  return 128 * (size_t)(c + cv) +
         (size_t)kDqWideStages * (2 * W + cv / 64) * kDqWideTk * 128 +
         kDqWideTk / 2 * 128 * 4 + 2 * sizeof(Ring<kDqWideStages>) +
         sizeof(uint64_t) + 1024;   // + 1024: aligning the base
}

template <int W>
__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_bwd_dq_wide_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
    const float* __restrict__ delta, int n, int nk, int c, int cv,
    float scale) {
  constexpr int TK = kDqWideTk, ST = kDqWideStages;
  constexpr int kSlotK = 2 * W * TK * 128;    // one k slot: 2W chunks
  constexpr int kXWords = TK / 2 * 128;       // the p / ds exchange slot
  const int nc = c / 64, nv = cv / 64;
  const int slot_v = nv * TK * 128;           // one v slot
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + 128 * c;
  unsigned char* kr = dos + 128 * cv;         // the k ring, then the v ring
  unsigned char* vr = kr + ST * kSlotK;
  float* xbuf = reinterpret_cast<float*>(vr + ST * slot_v);
  Ring<ST>* kring = reinterpret_cast<Ring<ST>*>(xbuf + kXWords);
  Ring<ST>* vring = kring + 1;
  uint64_t* rowbar = reinterpret_cast<uint64_t*>(vring + 1);

  const int bi = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tiles = (nk + TK - 1) / TK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    kring->init(kWConsumerWarps);          // both consumers read k
    vring->init(kWConsumerWarps / 2);      // consumer 1 alone reads v
    mbar_init(rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: q, do once and the k ring (thread 256); the v ring
    // (thread 288)
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(rowbar, 64 * (c + cv) * 2);
      for (int j = 0; j < nc; ++j)
        tma_load(qs + j * 8192, &qmap, rowbar, 64 * j, q0, bi);
      for (int j = 0; j < nv; ++j)
        tma_load(dos + j * 8192, &domap, rowbar, 64 * j, q0, bi);
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<ST>::slot(t);
        kring->wait_empty(t);
        mbar_expect_tx(&kring->full[s], TK * c * 2);
        for (int j = 0; j < nc; ++j)
          tma_load(kr + s * kSlotK + j * TK * 128, &kmap, &kring->full[s],
                   64 * j, TK * t, bi);
      }
    } else if (threadIdx.x == 288) {
      for (int t = 0; t < tiles; ++t) {
        const int s = Ring<ST>::slot(t);
        vring->wait_empty(t);
        mbar_expect_tx(&vring->full[s], TK * cv * 2);
        for (int j = 0; j < nv; ++j)
          tma_load(vr + s * slot_v + j * TK * 128, &vmap, &vring->full[s],
                   64 * j, TK * t, bi);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const float sl2 = scale * kLog2e;
    // this thread's rows warp * 16 + g + 8 h: lse (in log2 units) for
    // consumer 0, delta for consumer 1
    float rowstat[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + 8 * h;
      const float* stat = wg == 0 ? lse : delta;
      rowstat[h] = row < n ? stat[(size_t)bi * n + row] : 0.f;
      if (wg == 0) rowstat[h] *= kLog2e;
    }
    const int j0 = wg * W;                 // this consumer's first dq chunk
    uint32_t* xwords = reinterpret_cast<uint32_t*>(xbuf);

    float acc[W][32];
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    // Named barriers over both consumers (256 threads): 1 "p written", 2
    // "ds written". One exchange slot suffices: consumer 0 writes p of tile
    // t + 1 only after reading ds of tile t, consumer 1 writes ds only
    // after reading p.
    mbar_wait(rowbar, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = Ring<ST>::slot(t);
      uint32_t pa[TK / 16][4];
      if (wg == 0) {
        // ---- s = q k^T, p. Zeroed and pinned before the products: left
        // undefined, ptxas defines them inside the wgmma pipeline stage and
        // serializes every product of the kernel (C7515, PERF.md)
        float st[TK / 2] = {};
        reg_fence(st);
        kring->wait_full(t);
        wgmma_fence();
        ss_scores(st, smem_addr(qs), 8192, smem_addr(kr) + s * kSlotK, nc,
                  TK * 128);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) {
          const int col = TK * t + 8 * (i >> 2) + 2 * qd + (i & 1);
          xbuf[i * 128 + tid] =
              col < nk ? exp2f(st[i] * sl2 - rowstat[(i >> 1) & 1]) : 0.f;
        }
        named_arrive(1, 256);
        named_sync(2, 256);
#pragma unroll
        for (int j = 0; j < TK / 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[j][e] = xwords[(4 * j + e) * 128 + tid];
      } else {
        // ---- dp = do v^T, ds
        float dp[TK / 2] = {};   // as st above
        reg_fence(dp);
        vring->wait_full(t);
        wgmma_fence();
        ss_scores(dp, smem_addr(dos), 8192, smem_addr(vr) + s * slot_v, nv,
                  TK * 128);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dp);
        vring->release(t);
        named_sync(1, 256);
#pragma unroll
        for (int i = 0; i < TK / 2; ++i)
          dp[i] = xbuf[i * 128 + tid] * (dp[i] - rowstat[(i >> 1) & 1]) *
                  scale;
#pragma unroll
        for (int j = 0; j < TK / 16; ++j) {
          acc_to_a(pa[j], dp, j);
#pragma unroll
          for (int e = 0; e < 4; ++e) xwords[(4 * j + e) * 128 + tid] = pa[j][e];
        }
        named_arrive(2, 256);
        kring->wait_full(t);
      }
      // ---- dq[:, this consumer's chunks] += ds k
      const uint32_t kt = smem_addr(kr) + s * kSlotK + j0 * TK * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        rs_chunks(acc, pa[kk], kt + kk * 16 * 128, TK * 128);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < W; ++j) reg_fence(acc[j]);
#pragma unroll
      for (int j = 0; j < TK / 16; ++j) reg_fence(pa[j]);
      kring->release(t);
    }

    // ---- epilogue: dq in bf16, staged swizzled over q (free once
    // consumer 0's last s is done), one TMA store per existing 64-column
    // chunk; rows past n are clipped by the store
    named_sync(3, 256);
    unsigned char* stage = qs + j0 * 8192;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j0 + j >= nc) break;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp * 16 + g + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(
            stage + j * 8192 + swizzled_pair(r, 8 * (i >> 2) + 2 * qd)) =
            pack_pair(acc[j][i], acc[j][i + 1]);
      }
    }
    fence_proxy_async();
    named_sync(4 + wg, 128);
    if (tid == 0 && j0 < nc) {
      for (int j = 0; j < W && j0 + j < nc; ++j)
        tma_store(&dqmap, stage + j * 8192, 64 * (j0 + j), q0, bi);
      tma_store_drain();
    }
  }
}

template <int W>
int launch_dq_wide(const CUtensorMap (&maps)[5], const void* lse,
                   const void* delta, int b, int n, int nk, int c, int cv,
                   float scale, cudaStream_t stream) {
  const size_t smem = dq_wide_smem<W>(c, cv);
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(nonlocal_attention_bwd_dq_wide_kernel<W>,
                                     smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 63) / 64, b);
  nonlocal_attention_bwd_dq_wide_kernel<W><<<grid, kWThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(lse), static_cast<const float*>(delta), n, nk,
      c, cv, scale);
  return (int)cudaGetLastError();
}

int launch_dq_wgmma_wide(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int b, int n, int nk, int c, int cv,
                         float scale, cudaStream_t stream) {
  if (c % 64 || cv % 64 || c > 512 || cv > 512 || (c <= 256 && cv <= 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];   // q, k, v, do, dq
  if (!make_map(&maps[0], q, b, n, c, 64) ||
      !make_map(&maps[1], k, b, nk, c, kDqWideTk) ||
      !make_map(&maps[2], v, b, nk, cv, kDqWideTk) ||
      !make_map(&maps[3], dout, b, n, cv, 64) ||
      !make_map(&maps[4], dq, b, n, c, 64))
    return (int)cudaErrorNotSupported;
  // W = ceil(C / 128) chunks a consumer
  switch ((c / 64 + 1) / 2) {
    case 1:
      return launch_dq_wide<1>(maps, lse, delta, b, n, nk, c, cv, scale,
                               stream);
    case 2:
      return launch_dq_wide<2>(maps, lse, delta, b, n, nk, c, cv, scale,
                               stream);
    case 3:
      return launch_dq_wide<3>(maps, lse, delta, b, n, nk, c, cv, scale,
                               stream);
    default:
      return launch_dq_wide<4>(maps, lse, delta, b, n, nk, c, cv, scale,
                               stream);
  }
}

// ------------------------- f32, Hopper: TF32 wgmma + TMA (tf32_wgmma)
// The f32 K1-dq and K1-dkv (`_attn_dq_kernel`, `_attn_dkv_kernel`) for C
// and Cv up to 512, on Hopper's tensor-core instruction. One generic block
// program over rows and cols, as the tf32x3 program above (rows = queries
// for K1-dq, keys for K1-dkv), with the products of three TF32 halves
// (lo hi + hi lo + hi hi) on wgmma.mma_async m64nNk8.f32.tf32.tf32.
//
// TF32 wgmma reads both operands from shared memory K-major only, and the
// accumulating product X m contracts over the streamed axis: m (k for
// K1-dq; q and do for K1-dkv) must arrive with that axis contiguous. So a
// pre-pass (tf32_split_kernel in tf32_wgmma.cuh, shared with the f32
// K1-fwd; four launches a call) splits every operand
// once into its TF32 halves, hi = tf32(x) and lo = tf32(x - hi), and
// writes them to scratch the wrapper allocates: the row and column
// operands of s and dp as they are stored (rows of channels, padded with
// zeros to a multiple of 64), and m transposed, (channels, streamed axis).
// Each split operand is one tensor (2B, rows, cols): hi of item b at 2b,
// lo at 2b + 1, so one TMA map serves both halves. No warp splits an
// operand in the main kernel.
//
// A block owns 64 rows and 2 WN output columns of one part (WN = 32, 64 or
// 128 by the width; grid.z walks the parts and their column chunks: dq;
// dk, then dv). Warpgroup 2 produces (one thread issues every TMA copy
// into a ring of kGStages 32 KB slots); consumer warpgroups 0 and 1 take
// the 64-column tiles of the streamed axis in step:
//   s and dp: each consumer forms its 32 columns of the tile (m64n32k8)
//     over 32-channel stages (A: the rows' chunk, B: the columns' chunk,
//     both halves of each in one slot), kGUnroll stages back to back, each
//     summed from zero on the tensor cores (two partials in turn) and
//     added in f32 as soon as the next stage is queued behind it;
//   X = p or ds, zero outside the valid rows and columns, split into its
//     TF32 halves and written K-major and swizzled into the X buffer (its
//     32 columns of each), read by both consumers;
//   acc += X m: consumer g multiplies all of X (SS: A = X from shared
//     memory) by the columns [2 WN z + WN g, + WN) of m^T, two stages of
//     32 streamed positions, summed from zero over the tile (m64nWNk8) and
//     added to acc in f32; the first stage's slot is released as soon as
//     its products are done, so the next tile's stages load behind the
//     second's.
// Every sum on the tensor cores is at most 12 (s, dp) or 24 (X m) TF32
// products long before an f32 add takes it: their own accumulation
// truncates (see mma_tf32x3); summed over the whole axis instead, the
// gradients sat 5.5e-5 of the largest from f64 at layer 2, promoted 1.6e-6
// (the plain f32 backward 4.3e-6; tools/port_kernel_probes.py tw32). X
// goes through shared memory (both consumers need all of it), so the
// accumulating product is SS and holds no A fragments in registers: acc
// and its tile partial take WN registers, s, dp and their two partials 64.
// Every wgmma group is waited on in the loop iteration that issued it:
// with a stage's partial or a tile's X m group pending across iterations,
// ptxas serialized the wgmmas (+25%). K1-dq's multiply-adds per (query,
// key) are C + Cv + C, the minimum; K1-dkv's dv blocks form s again (C +
// Cv more than the minimum 2C + 2Cv at C = Cv = 256); 512 takes two
// column chunks, each forming s and dp.
//
// What bounds it: operations, 2.93 ms (K1-dq) and 3.91 ms (K1-dkv) at
// layer 2 at the TF32 rate over 3 (the header). It takes 5.7-6.0 and
// 9.9-10.6 ms there (H100 80GB HBM3, 700 W; PERF.md): the probe
// finds the time neither in the products (none of s and dp issued: no
// faster), nor in the copies from L2 (half the bytes: -2 to -9%; every
// block reading the same rows: -3 to -10%), nor in the pre-pass (0.29 /
// 0.32 ms); issuing the score stages eight at a time instead of by pairs
// took 5-10%. A ring round trip per stage sets the pace.
constexpr int kGRows = 64;        // rows per block
constexpr int kGCols = 64;        // streamed columns per tile
constexpr int kGChunk = 32;       // channels per stage: a 128-byte f32 row
constexpr int kGPad = 64;         // the split operands' channel padding
constexpr int kGStages = 6;       // ring slots
constexpr int kGXBufs = 1;        // X buffers
constexpr int kGUnroll = 8;       // score stages issued back to back
constexpr int kGXBytes = 32768;   // one X buffer: 2 halves x 2 chunks
constexpr int kGMaxWidth = 512;

struct TwParams {
  float* out0;          // part 0: dq or dk (X = ds)
  float* out1;          // part 1: dv (X = p)
  const float* lse;     // (B x n_stats), n_stats = rows or cols
  const float* delta;
  int rows, cols;
  int nc, nv;           // 32-channel stages of s and of dp (both even)
  int w0, w1;           // the parts' widths
  int zsplit;           // blocks with blockIdx.z < zsplit make part 0
  int stats_on_rows;    // 1 for dq
  float scale;
};

size_t tw_smem() {
  return (size_t)kGStages * kGSlot + kGXBufs * kGXBytes +
         sizeof(Ring<kGStages>) +
         1024;   // + 1024: aligning the base
}

// A completed stage's partial p joins s (an s stage) or dp by f32 adds.
__device__ __forceinline__ void tw_join(float (&s)[16], float (&dp)[16],
                                        float (&p)[16], bool to_s) {
  reg_fence(p);
  if (to_s) {
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] += p[e];
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) dp[e] += p[e];
  }
}

// The tile's U stages st + j .. st + j + U - 1 (U even) into p0 and p1 in
// turn: each stage joins s (below nc) or dp once the stage after it is
// queued behind it, so the tensor cores drain once, after the last; each
// slot is released once read. Every wgmma group is waited on in this call:
// ptxas serializes a warpgroup's wgmmas when a group read by other
// instructions is still pending across a loop iteration.
template <int U, int ST>
__device__ __forceinline__ void tw_stages(float (&s)[16], float (&dp)[16],
                                          float (&p0)[16], float (&p1)[16],
                                          Ring<ST>* ring, uint32_t ring_s,
                                          int st, int j, int nc,
                                          uint32_t b_off) {
  static_assert(U % 2 == 0, "stages go to p0 and p1 in pairs");
  tw_stage(p0, ring, ring_s, st + j, b_off);
#pragma unroll
  for (int i = 1; i < U; ++i) {
    if (i & 1) {
      tw_stage(p1, ring, ring_s, st + j + i, b_off);
      wgmma_wait<1>();
      tw_join(s, dp, p0, j + i - 1 < nc);
    } else {
      tw_stage(p0, ring, ring_s, st + j + i, b_off);
      wgmma_wait<1>();
      tw_join(s, dp, p1, j + i - 1 < nc);
    }
    ring->release(st + j + i - 1);
  }
  wgmma_wait<0>();
  tw_join(s, dp, p1, j + U - 1 < nc);
  ring->release(st + j + U - 1);
}

template <int WN>
__global__ void __launch_bounds__(kWThreads, 1)
nonlocal_attention_bwd_tf32_wgmma_kernel(
    const __grid_constant__ CUtensorMap ramap,
    const __grid_constant__ CUtensorMap camap,
    const __grid_constant__ CUtensorMap rbmap,
    const __grid_constant__ CUtensorMap cbmap,
    const __grid_constant__ CUtensorMap m0map,
    const __grid_constant__ CUtensorMap m1map, const TwParams p) {
  constexpr int ST = kGStages;
  constexpr int kMBytes = WN * 128;   // one TF32 half of an m stage
  static_assert(2 * kMBytes <= kGSlot, "an m stage fits a slot");
  static_assert(ST >= 4, "a tile's four m stages are held at once");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_p = align1024(smem_raw);
  unsigned char* xbuf = ring_p + ST * kGSlot;
  Ring<ST>* ring = reinterpret_cast<Ring<ST>*>(xbuf + kGXBufs * kGXBytes);

  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * kGRows;
  const int part = (int)blockIdx.z < p.zsplit ? 0 : 1;
  const int w_base = ((int)blockIdx.z - (part ? p.zsplit : 0)) * 2 * WN;
  const int n_dp = part == 0 ? p.nv : 0;   // part 1 (dv) needs no dp
  const int tiles = (p.cols + kGCols - 1) / kGCols;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    ring->init(kWConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: per tile the s stages, the dp stages, then the four m
    // stages (column chunk j / 2 of the tile for consumer j % 2)
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      const CUtensorMap* mmap = part ? &m1map : &m0map;
      int st = 0;
      for (int t = 0; t < tiles; ++t) {
        const int c0 = t * kGCols;
        for (int j = 0; j < p.nc + n_dp; ++j, ++st) {
          const bool is_s = j < p.nc;
          const int ch = (is_s ? j : j - p.nc) * kGChunk;
          const CUtensorMap* am = is_s ? &ramap : &rbmap;
          const CUtensorMap* bm = is_s ? &camap : &cbmap;
          unsigned char* slot = ring_p + Ring<ST>::slot(st) * kGSlot;
          uint64_t* full = &ring->full[Ring<ST>::slot(st)];
          ring->wait_empty(st);
          mbar_expect_tx(full, kGSlot);
          tma_load(slot, am, full, ch, r0, 2 * bi);
          tma_load(slot + 8192, am, full, ch, r0, 2 * bi + 1);
          tma_load(slot + 16384, bm, full, ch, c0, 2 * bi);
          tma_load(slot + 24576, bm, full, ch, c0, 2 * bi + 1);
        }
        for (int j = 0; j < 4; ++j, ++st) {
          unsigned char* slot = ring_p + Ring<ST>::slot(st) * kGSlot;
          uint64_t* full = &ring->full[Ring<ST>::slot(st)];
          const int col = c0 + (j >> 1) * kGChunk, row = w_base + (j & 1) * WN;
          ring->wait_empty(st);
          mbar_expect_tx(full, 2 * kMBytes);
          tma_load(slot, mmap, full, col, row, 2 * bi);
          tma_load(slot + kMBytes, mmap, full, col, row, 2 * bi + 1);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const uint32_t ring_s = smem_addr(ring_p);
    const uint32_t x_s = smem_addr(xbuf);
    const int n_stats = p.stats_on_rows ? p.rows : p.cols;
    const float* lse = p.lse + (size_t)bi * n_stats;
    const float* delta = p.delta + (size_t)bi * n_stats;
    // rows warp * 16 + g (h = 0) and + 8 (h = 1) of the block
    float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
    if (p.stats_on_rows) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + warp * 16 + g + 8 * h;
        if (row < p.rows) {
          lse_r[h] = lse[row];
          delta_r[h] = delta[row];
        }
      }
    }
    // zeroed and pinned before the products: ptxas serializes the wgmmas
    // of an accumulator first defined inside the pipeline (C7515)
    float acc[WN / 2], pa[WN / 2], s[16], dp[16], p0[16], p1[16];
#pragma unroll
    for (int e = 0; e < WN / 2; ++e) acc[e] = pa[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) p0[e] = p1[e] = 0.f;
    reg_fence(acc);
    reg_fence(pa);
    reg_fence(p0);
    reg_fence(p1);

    const uint32_t b_off = wg * 4096;   // the consumer's 32 columns
    int st = 0;   // the next ring stage
    for (int t = 0; t < tiles; ++t) {
      const int c0 = t * kGCols;
      // this consumer's columns c0 + 32 wg + 8 j + 2 qd + e: their lse and
      // delta (K1-dkv), loaded before the products, behind which the loads'
      // latency hides
      float lse_c[8], delta_c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c0 + 32 * wg + 8 * (i >> 1) + 2 * qd + (i & 1);
        const bool load = !p.stats_on_rows && col < p.cols;
        lse_c[i] = load ? lse[col] : 0.f;
        delta_c[i] = load ? delta[col] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = dp[e] = 0.f;
      // ---- s and dp: the tile's stage j (s below nc, dp past it), kGUnroll
      // at a time, a remainder by pairs (nc and n_dp are even)
      const int n = p.nc + n_dp;
      int js = 0;
      for (; js + kGUnroll <= n; js += kGUnroll)
        tw_stages<kGUnroll>(s, dp, p0, p1, ring, ring_s, st, js, p.nc, b_off);
      for (; js < n; js += 2)
        tw_stages<2>(s, dp, p0, p1, ring, ring_s, st, js, p.nc, b_off);
      st += n;

      // ---- X: this consumer's columns, as TF32 halves into chunk wg of X
      // buffer t % kGXBufs. Free: each consumer's X m product of tile t - 1
      // completed before its s and dp above; with two buffers, both
      // consumers passed tile t - 1's barrier after their product on tile
      // t - 2; with one, the barrier here.
      if (kGXBufs == 1) named_sync(2, 256);
      unsigned char* xb = xbuf + (t % kGXBufs) * kGXBytes + wg * 8192;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ct = 8 * j + 2 * qd;           // column in the chunk
        const int col = c0 + 32 * wg + ct;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = warp * 16 + g + 8 * h;  // row in the block
          float2 hi, lo;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float l = p.stats_on_rows ? lse_r[h] : lse_c[2 * j + e];
            const float d = p.stats_on_rows ? delta_r[h] : delta_c[2 * j + e];
            float x = 0.f;
            if (r0 + rt < p.rows && col + e < p.cols) {
              x = expf(s[4 * j + 2 * h + e] * p.scale - l);
              if (n_dp) x *= (dp[4 * j + 2 * h + e] - d) * p.scale;
            }
            uint32_t xh, xl;
            split_tf32(x, xh, xl);
            (e ? hi.y : hi.x) = __uint_as_float(xh);
            (e ? lo.y : lo.x) = __uint_as_float(xl);
          }
          *reinterpret_cast<float2*>(xb + swizzled_f32(rt, ct)) = hi;
          *reinterpret_cast<float2*>(xb + 16384 + swizzled_f32(rt, ct)) = lo;
        }
      }
      fence_proxy_async();
      named_sync(1, 256);   // X of both consumers written

      // ---- acc += X m over the tile's two column chunks: this consumer's
      // m stages are st + wg and st + 2 + wg, the other two it releases at
      // once; chunk 0's own slot is released as soon as its group is done,
      // so the next tile's stages load behind chunk 1's products
#pragma unroll
      for (int j = 0; j < 4; ++j) ring->wait_full(st + j);
      ring->release(st + 1 - wg);
      ring->release(st + 3 - wg);
      const uint32_t xs = x_s + (t % kGXBufs) * kGXBytes;
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t m = ring_s + Ring<ST>::slot(st + 2 * i + wg) * kGSlot;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32x3(pa, xs + i * 8192 + 32 * kk,
                       xs + 16384 + i * 8192 + 32 * kk, m + 32 * kk,
                       m + kMBytes + 32 * kk, (i | kk) == 0);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();
      ring->release(st + wg);
      wgmma_wait<0>();
      reg_fence(pa);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[e] += pa[e];
      ring->release(st + 2 + wg);
      st += 4;
    }

    // ---- epilogue: acc (rows warp * 16 + g + 8 h, columns w_base + WN wg
    // + 8 j + 2 qd + e) straight to the output
    float* out = part ? p.out1 : p.out0;
    const int w = part ? p.w1 : p.w0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + warp * 16 + g + 8 * h;
      if (row >= p.rows) continue;
      float* orow = out + ((size_t)bi * p.rows + row) * w;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = w_base + WN * wg + 8 * j + 2 * qd + e;
          if (col < w) orow[col] = acc[4 * j + 2 * h + e];
        }
    }
  }
}

// The scratch a call takes: the split row and column operands of s and
// dp, m0 = the column operand of s transposed (k^T for K1-dq, q^T for
// K1-dkv) and, for K1-dkv, m1 = do^T.
size_t tw_scratch_bytes(bool dkv, int b, int rows, int cols, int c, int cv) {
  const int cp = round_up(c, kGPad), cvp = round_up(cv, kGPad);
  const int colp = round_up(cols, 4);
  return tw_region(b, rows, cp) + tw_region(b, cols, cp) +
         tw_region(b, rows, cvp) + tw_region(b, cols, cvp) +
         tw_region(b, cp, colp) + (dkv ? tw_region(b, cvp, colp) : 0);
}

template <int WN>
int launch_tw(const CUtensorMap (&maps)[6], const TwParams& p, int b, int z,
              cudaStream_t stream) {
  auto kernel = nonlocal_attention_bwd_tf32_wgmma_kernel<WN>;
  const size_t smem = tw_smem();
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.rows + kGRows - 1) / kGRows, b, z);
  kernel<<<grid, kWThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                            maps[3], maps[4], maps[5], p);
  return (int)cudaGetLastError();
}

// K1-dq (dkv = false: rows = queries, ra = q, ca = k, rb = do, cb = v, out0
// = dq) or K1-dkv (rows = keys, ra = k, ca = q, rb = v, cb = do, out0 = dk,
// out1 = dv): the pre-pass, then the main kernel.
int run_tf32_wgmma(bool dkv, const void* ra_src, const void* ca_src,
                   const void* rb_src, const void* cb_src, const void* lse,
                   const void* delta, void* out0, void* out1, void* scratch,
                   int b, int rows, int cols, int c, int cv, float scale,
                   cudaStream_t stream) {
  if (c > kGMaxWidth || cv > kGMaxWidth || 2 * b > 65535)
    return (int)cudaErrorInvalidValue;
  const int cp = round_up(c, kGPad), cvp = round_up(cv, kGPad);
  const int colp = round_up(cols, 4);
  unsigned char* at = static_cast<unsigned char*>(scratch);
  auto take = [&](int r, int cc) {
    float* f = reinterpret_cast<float*>(at);
    at += tw_region(b, r, cc);
    return f;
  };
  float* ra = take(rows, cp);
  float* ca = take(cols, cp);
  float* rb = take(rows, cvp);
  float* cb = take(cols, cvp);
  float* m0 = take(cp, colp);
  float* m1 = dkv ? take(cvp, colp) : m0;
  int err;
  if ((err = launch_split(static_cast<const float*>(ra_src), ra, nullptr, b,
                          rows, c, cp, stream)) ||
      (err = launch_split(static_cast<const float*>(ca_src), ca, m0, b, cols,
                          c, cp, stream)) ||
      (err = launch_split(static_cast<const float*>(rb_src), rb, nullptr, b,
                          rows, cv, cvp, stream)) ||
      (err = launch_split(static_cast<const float*>(cb_src), cb,
                          dkv ? m1 : nullptr, b, cols, cv, cvp, stream)))
    return err;
  // WN: each consumer's output columns, the narrowest that covers the
  // widest part in one chunk, 128 past that (the rest over grid.z)
  const int wmax = dkv && cvp > cp ? cvp : cp;
  const int wn = wmax <= 64 ? 32 : wmax <= 128 ? 64 : 128;
  CUtensorMap maps[6];   // ra, ca, rb, cb, m0, m1
  if (!make_map_f32(&maps[0], ra, 2 * b, rows, cp, kGRows) ||
      !make_map_f32(&maps[1], ca, 2 * b, cols, cp, kGCols) ||
      !make_map_f32(&maps[2], rb, 2 * b, rows, cvp, kGRows) ||
      !make_map_f32(&maps[3], cb, 2 * b, cols, cvp, kGCols) ||
      !make_map_f32(&maps[4], m0, 2 * b, cp, colp, wn) ||
      !make_map_f32(&maps[5], m1, 2 * b, dkv ? cvp : cp, colp, wn))
    return (int)cudaErrorNotSupported;
  TwParams p;
  p.out0 = static_cast<float*>(out0);
  p.out1 = static_cast<float*>(out1);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.rows = rows;
  p.cols = cols;
  p.nc = cp / kGChunk;
  p.nv = cvp / kGChunk;
  p.w0 = c;
  p.w1 = cv;
  p.zsplit = (cp + 2 * wn - 1) / (2 * wn);
  p.stats_on_rows = !dkv;
  p.scale = scale;
  const int z = p.zsplit + (dkv ? (cvp + 2 * wn - 1) / (2 * wn) : 0);
  switch (wn) {
    case 32: return launch_tw<32>(maps, p, b, z, stream);
    case 64: return launch_tw<64>(maps, p, b, z, stream);
    default: return launch_tw<128>(maps, p, b, z, stream);
  }
}

bool bad_shape(int b, int n, int nk, int c, int cv) {
  return b < 1 || n < 1 || nk < 1 || c < 1 || cv < 1 || b > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, on the current
// device; lse and delta f32. Returns the cudaError_t of the launch.
int pt_nonlocal_attention_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int n,
                                 int nk, int c, int cv, float scale, int dtype,
                                 void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_dq<float>(q, k, v, dout, lse, delta, dq, b, n, nk, c, cv,
                         scale, s);
  if (dtype == 1)
    return run_dq<bf16>(q, k, v, dout, lse, delta, dq, b, n, nk, c, cv, scale,
                        s);
  return (int)cudaErrorInvalidValue;
}

int pt_nonlocal_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int n, int nk, int c, int cv, float scale,
                                  int dtype, void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_dkv<float>(q, k, v, dout, lse, delta, dk, dv, b, n, nk, c, cv,
                          scale, s);
  if (dtype == 1)
    return run_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, b, n, nk, c, cv,
                         scale, s);
  return (int)cudaErrorInvalidValue;
}

// The f32 tensor-core program (tf32x3): the same functions as
// pt_nonlocal_attention_bwd_dq and pt_nonlocal_attention_bwd_dkv in f32,
// for C and Cv up to kTMaxWidth (the caller's dispatch picks it).
int pt_nonlocal_attention_bwd_dq_tf32x3(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq, int b, int n, int nk, int c,
                                        int cv, float scale, void* stream) {
  if (bad_shape(b, n, nk, c, cv) || c > kTMaxWidth || cv > kTMaxWidth)
    return (int)cudaErrorInvalidValue;
  BwdParams<float> p = dq_params<float>(q, k, v, dout, lse, delta, dq, n, nk,
                                        c, cv, scale);
  return launch_tf32x3(p, b, false, static_cast<cudaStream_t>(stream));
}

int pt_nonlocal_attention_bwd_dkv_tf32x3(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int b, int n,
                                         int nk, int c, int cv, float scale,
                                         void* stream) {
  if (bad_shape(b, n, nk, c, cv) || c > kTMaxWidth || cv > kTMaxWidth)
    return (int)cudaErrorInvalidValue;
  BwdParams<float> p = dkv_params<float>(q, k, v, dout, lse, delta, dk, dv, n,
                                         nk, c, cv, scale);
  return launch_tf32x3(p, b, true, static_cast<cudaStream_t>(stream));
}

// The f32 TF32-wgmma program (tf32_wgmma): the same functions as
// pt_nonlocal_attention_bwd_dq and pt_nonlocal_attention_bwd_dkv in f32,
// for C and Cv up to kGMaxWidth, with `scratch` (16-byte aligned) of
// pt_nonlocal_attention_bwd_tf32_wgmma_scratch bytes for the operands'
// TF32 halves. Any f32 tensors: the pre-pass reads them with plain loads.
long long pt_nonlocal_attention_bwd_tf32_wgmma_scratch(int dkv, int b, int n,
                                                       int nk, int c,
                                                       int cv) {
  return (long long)(dkv ? tw_scratch_bytes(true, b, nk, n, c, cv)
                         : tw_scratch_bytes(false, b, n, nk, c, cv));
}

int pt_nonlocal_attention_bwd_dq_tf32_wgmma(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dq,
                                            void* scratch, int b, int n,
                                            int nk, int c, int cv,
                                            float scale, void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return run_tf32_wgmma(false, q, k, dout, v, lse, delta, dq, dq, scratch, b,
                        n, nk, c, cv, scale,
                        static_cast<cudaStream_t>(stream));
}

int pt_nonlocal_attention_bwd_dkv_tf32_wgmma(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const void* lse,
                                             const void* delta, void* dk,
                                             void* dv, void* scratch, int b,
                                             int n, int nk, int c, int cv,
                                             float scale, void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return run_tf32_wgmma(true, k, q, v, dout, lse, delta, dk, dv, scratch, b,
                        nk, n, c, cv, scale,
                        static_cast<cudaStream_t>(stream));
}

// The bf16 wgmma kernel: the same function as pt_nonlocal_attention_bwd_dkv,
// for C and Cv multiples of 64 up to 256 and 16-byte aligned tensors (the
// caller's dispatch picks it).
int pt_nonlocal_attention_bwd_dkv_wgmma(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int b, int n,
                                        int nk, int c, int cv, float scale,
                                        void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return launch_dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, b, n, nk, c, cv,
                          scale, static_cast<cudaStream_t>(stream));
}

// The wide bf16 wgmma kernel: the same function as
// pt_nonlocal_attention_bwd_dkv, for C and Cv multiples of 64 up to 512 with
// one of them above 256, and 16-byte aligned tensors (the caller's
// dispatch picks it).
int pt_nonlocal_attention_bwd_dkv_wgmma_wide(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const void* lse,
                                             const void* delta, void* dk,
                                             void* dv, int b, int n, int nk,
                                             int c, int cv, float scale,
                                             void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return launch_dkv_wgmma_wide(q, k, v, dout, lse, delta, dk, dv, b, n, nk, c,
                               cv, scale, static_cast<cudaStream_t>(stream));
}

// The bf16 wgmma kernel: the same function as pt_nonlocal_attention_bwd_dq,
// for C and Cv multiples of 64 up to 256 and 16-byte aligned tensors (the
// caller's dispatch picks it).
int pt_nonlocal_attention_bwd_dq_wgmma(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int b, int n, int nk, int c,
                                       int cv, float scale, void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return launch_dq_wgmma(q, k, v, dout, lse, delta, dq, b, n, nk, c, cv,
                         scale, static_cast<cudaStream_t>(stream));
}

// The wide bf16 wgmma kernel: the same function as
// pt_nonlocal_attention_bwd_dq, for C and Cv multiples of 64 up to 512 with
// one of them above 256, and 16-byte aligned tensors (the caller's dispatch
// picks it).
int pt_nonlocal_attention_bwd_dq_wgmma_wide(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dq,
                                            int b, int n, int nk, int c,
                                            int cv, float scale,
                                            void* stream) {
  if (bad_shape(b, n, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return launch_dq_wgmma_wide(q, k, v, dout, lse, delta, dq, b, n, nk, c, cv,
                              scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
