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
// chunks of the K1-dkv grid, so a dv block skips dp. Two paths, chosen by
// dtype:
//
// * bf16 (the model's path): tensor cores through mma.sync.m16n8k16, warps
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

}  // extern "C"
