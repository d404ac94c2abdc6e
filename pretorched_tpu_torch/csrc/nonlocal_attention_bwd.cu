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
// 6272, C = Cv = 256) the backward needs 2 B N Nk (3C + 2Cv) = 806 GFLOP
// against ~0.2 GB of operands in bf16: bound by the matrix units, 0.82 ms
// at the card's bf16 peak.
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
// registers, and accumulates X times a 64-row tile of the third operand. A
// block keeps only a column chunk of its accumulator (128 columns in bf16,
// 64 in f32) in registers, and the chunks go over grid.z: the accumulator
// of a 64-row block at C = 512 would take 256 KB in f32, more than the 227
// KB a block may have, and C reaches 1024 in gaussian mode. Each chunk
// recomputes s and dp: at C = Cv = 256 in bf16 that is 2.6x the minimal
// FLOPs, bought for register-resident accumulators. dk and dv are separate
// chunks of the K1-dkv grid, so a dv block skips dp. The caller's dispatch
// picks one of three programs:
//
// * K1-dkv in bf16 with C and Cv multiples of 64 up to 256 (the train
//   layer-2 shape): a warp-specialised wgmma kernel with TMA, which forms
//   s^T once and keeps both whole accumulators in registers
//   (nonlocal_attention_bwd_dkv_wgmma_kernel below, wgmma_tiles.cuh).
//   K1-dq always takes the generic program.
// * bf16 otherwise (K1-dq; K1-dkv at layer 3's and gaussian mode's widths):
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
// * f32: scalar FMAs (TF32 would break the f32 tolerance), 16 x 16
//   threads, each with a 4 x 4 register tile; X passes through shared
//   memory. Its third operand is staged by plain loads between barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
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

// K1-dq: rows = queries, cols = keys, one part: dq += ds k.
template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int b, int n, int nk,
           int c, int cv, float scale, cudaStream_t stream) {
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
  const int z = chunks(c, chunk_width<T>());
  p.zsplit = z;
  p.part0 = Part<T>{static_cast<const T*>(k), static_cast<T*>(dq), c, 1};
  p.part1 = p.part0;
  return launch(p, b, z, stream);
}

// K1-dkv: rows = keys, cols = queries; part 0 makes dk += ds^T q, part 1
// dv += p^T do.
template <typename T>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int b,
            int n, int nk, int c, int cv, float scale, cudaStream_t stream) {
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
  const int zk = chunks(c, chunk_width<T>());
  const int zv = chunks(cv, chunk_width<T>());
  p.zsplit = zk;
  p.part0 = Part<T>{static_cast<const T*>(q), static_cast<T*>(dk), c, 1};
  p.part1 = Part<T>{static_cast<const T*>(dout), static_cast<T*>(dv), cv, 0};
  return launch(p, b, zk + zv, stream);
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

}  // extern "C"
