// Fused eval-mode bottleneck tail for Hopper (sm_90a), K2:
//   y2  = relu(conv2(y1) * s2 + b2), rounded to the input type
//         (conv2: kernel (1, 3, 3), stride 1, padding (0, 1, 1), bias-free)
//   y3  = conv3(y2) * s3 + b3                    (conv3: 1x1x1, bias-free)
//   res = x, or conv_p(x) * sp + bp              (1x1x1 projection shortcut)
//   out = relu(y3 + res)
// with every BN folded to a per-channel scale and shift (s, b) and f32
// accumulation throughout.
//
// Replaces the TPU kernel `_kernel` (pretorched_tpu/ops/pallas/
// fused_block.py:69, launched by `fused_bottleneck_tail` at l.190). Same
// semantics, including the rounding of y2 to the input type before conv3;
// f32 or bf16 in, the input type out. The layout is the port's own,
// channels-first (N, C, T, H, W), read in place: no transposed copy of y1,
// x or out exists.
//
// What bounds it. On the SlowFast fast pathway (Cm <= 32) a block is a few
// thousand FLOP per pixel against 2 * (Cm + Cin + Cout) bytes of y1, x and
// out in bf16: bound by memory, as the TPU kernel was. The fusion is the
// point: y2 and y3 never reach device memory, so the tail moves |y1| + |x|
// + |out| instead of cuDNN's 2|y1| + 2|y2| + 2|y3| + |x| + |out| (plus the
// BN and ReLU passes).
//
// Design. The TPU kernel tiles the flattened B*T axis with whole frames in
// VMEM and picks the tile from a lane-padded VMEM budget. Here one block
// owns TH full-width rows of one frame (about 256 pixels), so each channel
// of its tile is one contiguous run of the frame plane. Two paths:
//
// * bf16 on tensor cores (mma.sync.m16n8k16), where every channel count is
//   a multiple of 8, Cm <= 64 and the tile fits shared memory: the
//   slice's path, described at fused_bottleneck_tail_mma_kernel below.
// * CUDA cores (f32 always, and bf16 for every other shape), per block:
//   1. conv2: input channels are staged KC at a time into shared memory as
//      a (KC, TH + 2, W + 2) tile with its one-pixel halo, zero-filled at
//      the frame's border; each thread accumulates CO2 output channels of
//      one pixel in registers; partial sums of a chunk wait in the y2 tile
//      between input chunks. The last chunk applies (s2, b2), the ReLU and
//      the rounding and leaves y2 in shared memory, (Cm, TH * W) in f32.
//   2. conv3 and the residual: for 32 output channels at a time, each
//      thread forms y3 of its pixel from the y2 tile, adds x (or its
//      projection, from global memory), applies the ReLU and stores.
//   Weights come in f32, already rounded to the input type, in the layouts
//   (Cin, 9, Cm) for conv2 and (Cin, Cout) for conv3 and the projection,
//   the output dim padded with zeros to the chunk width, so every weight
//   read is a 16-byte load that all threads of a warp share. Any Cm, Cin,
//   Cout run; a wide Cm only shrinks the tile. Scalar f32 FMAs: a load for
//   every 4 FMAs, so it waits on loads (see PERF.md).
// Neither path uses cp.async, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kThreads = 256;        // threads of a block (at most)
constexpr int kKC = 16;              // conv2 input channels staged at once
constexpr int kCO3 = 32;             // conv3 output channels per pass
constexpr size_t kMaxSmem = 200 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[j] += v * w[j], j < 4 * N4, w a 16-byte-aligned row of the weights
template <int N4>
__device__ __forceinline__ void fma_row(float* acc, float v, const float* w) {
#pragma unroll
  for (int j = 0; j < N4; ++j) {
    const float4 wv = ldg4(w + 4 * j);
    acc[4 * j + 0] = fmaf(v, wv.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(v, wv.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(v, wv.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(v, wv.w, acc[4 * j + 3]);
  }
}

// One block: rows [y0, y0 + TH) of frame (n, t). Shared memory: the halo
// tile y1h (kKC, TH + 2, W + 2), then the y2 tile (cm_pad, TH * W).
// w2t (cm, 9, cm_pad), w3t (cm, cout_pad), wpt (cin, cout_pad): f32 with
// zero padding; a2 (2, cm), a3 and ap (2, cout): folded [scale; shift].
template <typename T, int CO2, bool PROJ>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_tail_kernel(const T* __restrict__ y1, const T* __restrict__ x,
                             const float* __restrict__ w2t,
                             const float* __restrict__ a2,
                             const float* __restrict__ w3t,
                             const float* __restrict__ a3,
                             const float* __restrict__ wpt,
                             const float* __restrict__ ap,
                             T* __restrict__ out, int tlen, int h, int w,
                             int cm, int cin, int cout, int th, int tiles) {
  extern __shared__ float smem[];
  const int frame = blockIdx.x / tiles;
  const int y0 = (blockIdx.x % tiles) * th;
  const int n = frame / tlen, t = frame % tlen;
  const int rows = min(th, h - y0);
  const int npix = rows * w;              // valid pixels of this tile
  const int ptile = th * w;               // row stride of the y2 tile
  const int hw = h * w;
  const int64_t plane = (int64_t)tlen * hw;    // channel stride
  const int hrow = w + 2, hplane = (th + 2) * hrow;
  const int cm_pad = (cm + CO2 - 1) / CO2 * CO2;
  const int cout_pad = (cout + kCO3 - 1) / kCO3 * kCO3;
  float* y1h = smem;
  float* y2s = smem + kKC * hplane;
  // offset of (channel 0, this frame, tile's first pixel) in a tensor of
  // C channels: ((n * C) * T + t) * H * W + y0 * W
  auto base = [&](int c) {
    return ((int64_t)n * c * tlen + t) * hw + (int64_t)y0 * w;
  };
  const int64_t y1_base = base(cm), x_base = base(cin), out_base = base(cout);

  // 1. conv2 -> (s2, b2) -> relu -> round, into y2s
  for (int c0 = 0; c0 < cm; c0 += CO2) {
    for (int k0 = 0; k0 < cm; k0 += kKC) {
      const int kc = min(kKC, cm - k0);
      const bool last = k0 + kKC >= cm;
      __syncthreads();                    // y1h free again
      for (int i = threadIdx.x; i < kc * hplane; i += blockDim.x) {
        const int ci = i / hplane, r = i % hplane;
        const int gy = y0 - 1 + r / hrow, gx = r % hrow - 1;
        float v = 0.f;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w)
          v = to_f(y1[y1_base + (k0 + ci) * plane + (int64_t)(gy - y0) * w +
                      gx]);
        y1h[i] = v;
      }
      __syncthreads();
      for (int p = threadIdx.x; p < npix; p += blockDim.x) {
        const int py = p / w, px = p % w;
        float acc[CO2];
#pragma unroll
        for (int j = 0; j < CO2; ++j)
          acc[j] = k0 == 0 ? 0.f : y2s[(c0 + j) * ptile + p];
        for (int ci = 0; ci < kc; ++ci) {
          const float* src = y1h + ci * hplane + py * hrow + px;
          const float* wrow = w2t + (int64_t)(k0 + ci) * 9 * cm_pad + c0;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              fma_row<CO2 / 4>(acc, src[dy * hrow + dx],
                               wrow + (dy * 3 + dx) * cm_pad);
          }
        }
#pragma unroll
        for (int j = 0; j < CO2; ++j) {
          float v = acc[j];
          if (last) {
            const int c = c0 + j;
            v = c < cm ? round_as(fmaxf(fmaf(v, a2[c], a2[cm + c]), 0.f), y1)
                       : 0.f;
          }
          y2s[(c0 + j) * ptile + p] = v;
        }
      }
    }
  }
  __syncthreads();

  // 2. conv3 -> (s3, b3) -> + residual -> relu -> out
  for (int o0 = 0; o0 < cout; o0 += kCO3) {
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
      float acc[kCO3];
#pragma unroll
      for (int j = 0; j < kCO3; ++j) acc[j] = 0.f;
      for (int c = 0; c < cm; ++c)
        fma_row<kCO3 / 4>(acc, y2s[c * ptile + p],
                          w3t + (int64_t)c * cout_pad + o0);
      float res[kCO3];
      if (PROJ) {
#pragma unroll
        for (int j = 0; j < kCO3; ++j) res[j] = 0.f;
        for (int c = 0; c < cin; ++c)
          fma_row<kCO3 / 4>(res, to_f(x[x_base + c * plane + p]),
                            wpt + (int64_t)c * cout_pad + o0);
      }
#pragma unroll
      for (int j = 0; j < kCO3; ++j) {
        const int co = o0 + j;
        if (co < cout) {
          const float r = PROJ ? fmaf(res[j], ap[co], ap[cout + co])
                               : to_f(x[x_base + co * plane + p]);
          const float v = fmaf(acc[j], a3[co], a3[cout + co]) + r;
          store(out + out_base + co * plane + p, fmaxf(v, 0.f));
        }
      }
    }
  }
}

size_t smem_bytes(int th, int w, int cm_pad) {
  return sizeof(float) * ((size_t)kKC * (th + 2) * (w + 2) +
                          (size_t)cm_pad * th * w);
}

template <typename T, int CO2, bool PROJ>
cudaError_t launch(const void* y1, const void* x, const float* w2t,
                   const float* a2, const float* w3t, const float* a3,
                   const float* wpt, const float* ap, void* out, int n,
                   int tlen, int h, int w, int cm, int cin, int cout,
                   cudaStream_t stream) {
  const int cm_pad = (cm + CO2 - 1) / CO2 * CO2;
  // about kThreads pixels a block, fewer rows where the y2 tile is wide,
  // then rows spread evenly over the tiles of a frame
  int th = h < kThreads / w ? h : kThreads / w;
  if (th < 1) th = 1;
  while (th > 1 && smem_bytes(th, w, cm_pad) > kMaxSmem) --th;
  const size_t smem = smem_bytes(th, w, cm_pad);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int tiles_needed = (h + th - 1) / th;
  th = (h + tiles_needed - 1) / tiles_needed;
  const int tiles = (h + th - 1) / th;
  const int64_t blocks = (int64_t)n * tlen * tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  int threads = (th * w + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  auto kernel = fused_bottleneck_tail_kernel<T, CO2, PROJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(y1), static_cast<const T*>(x), w2t, a2, w3t, a3,
      wpt, ap, static_cast<T*>(out), tlen, h, w, cm, cin, cout, th, tiles);
  return cudaGetLastError();
}

template <typename T, bool PROJ>
cudaError_t launch_cm(const void* y1, const void* x, const float* w2t,
                      const float* a2, const float* w3t, const float* a3,
                      const float* wpt, const float* ap, void* out, int n,
                      int tlen, int h, int w, int cm, int cin, int cout,
                      cudaStream_t s) {
  if (cm <= 8)
    return launch<T, 8, PROJ>(y1, x, w2t, a2, w3t, a3, wpt, ap, out, n, tlen,
                              h, w, cm, cin, cout, s);
  if (cm <= 16)
    return launch<T, 16, PROJ>(y1, x, w2t, a2, w3t, a3, wpt, ap, out, n,
                               tlen, h, w, cm, cin, cout, s);
  return launch<T, 32, PROJ>(y1, x, w2t, a2, w3t, a3, wpt, ap, out, n, tlen,
                             h, w, cm, cin, cout, s);
}

template <typename T>
cudaError_t launch_t(const void* y1, const void* x, const float* w2t,
                     const float* a2, const float* w3t, const float* a3,
                     const float* wpt, const float* ap, void* out, int n,
                     int tlen, int h, int w, int cm, int cin, int cout,
                     cudaStream_t s) {
  if (wpt != nullptr)
    return launch_cm<T, true>(y1, x, w2t, a2, w3t, a3, wpt, ap, out, n, tlen,
                              h, w, cm, cin, cout, s);
  return launch_cm<T, false>(y1, x, w2t, a2, w3t, a3, wpt, ap, out, n, tlen,
                             h, w, cm, cin, cout, s);
}


// ---------------------------------------------------------------------------
// The bf16 path on tensor cores (mma.sync.m16n8k16, f32 accumulation), for
// Cm a multiple of 8 up to 64 and Cin, Cout multiples of 8. The block owns
// the same tile; shared memory holds it channels-last, so every product is
// a GEMM of 16-pixel rows:
//   conv2 = sum over the 9 taps of y1h[pixel + tap offset][ci] @ w2[tap]
//   (ldmatrix takes one row address a lane, so the tap's shift is free),
//   conv3 = y2[pixel][cm] @ w3, the projection = x[pixel][cin] @ wp.
// Channel dims are zero-padded to 16 (K of one mma) plus 8 elements of row
// padding against bank conflicts (kPad). Each warp takes 16-pixel tiles
// and carries one from y1 to the output: conv2 into its rows of the y2
// tile (bf16, rounded as the plain version rounds), then conv3 32 output
// channels at a time, the residual and the store. The weights come from
// the host already in these layouts (bf16, padded) and are copied whole.

constexpr int kMmaWarps = 8;
constexpr int kPad = 8;

__host__ __device__ __forceinline__ int padded(int c) {
  return (c + 15) / 16 * 16 + kPad;
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, int n) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) d[i] = s[i];
}

size_t mma_smem_bytes(int th, int w, int cm, int cin, int cout, bool proj) {
  const size_t mt16 = (size_t)(th * w + 15) / 16 * 16;
  const size_t cmp = padded(cm), cinp = padded(cin);
  size_t elems = (size_t)(th + 2) * (w + 2) * cmp   // y1 halo tile
                 + 9 * (size_t)cm * cmp             // w2
                 + mt16 * cmp                       // y2 tile
                 + (size_t)cout * cmp;              // w3
  if (proj) elems += mt16 * cinp + (size_t)cout * cinp;   // x tile, wp
  return elems * sizeof(bf16);
}

// y1 (n, cm, t, h, w), x (n, cin, t, h, w), out (n, cout, t, h, w) bf16;
// w2b (9, cm, padded(cm)), w3b (cout, padded(cm)), wpb (cout,
// padded(cin)) bf16; a2 (2, cm), a3, ap (2, cout) f32.
template <int CM, bool PROJ>
__global__ void __launch_bounds__(kMmaWarps * 32)
fused_bottleneck_tail_mma_kernel(const bf16* __restrict__ y1,
                                 const bf16* __restrict__ x,
                                 const bf16* __restrict__ w2b,
                                 const float* __restrict__ a2,
                                 const bf16* __restrict__ w3b,
                                 const float* __restrict__ a3,
                                 const bf16* __restrict__ wpb,
                                 const float* __restrict__ ap,
                                 bf16* __restrict__ out, int tlen, int h,
                                 int w, int cm, int cin, int cout, int th,
                                 int tiles) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int frame = blockIdx.x / tiles;
  const int y0 = (blockIdx.x % tiles) * th;
  const int n = frame / tlen, t = frame % tlen;
  const int npix = min(th, h - y0) * w;
  const int mt = (th * w + 15) / 16;           // 16-pixel tiles
  const int hw = h * w;
  const int64_t plane = (int64_t)tlen * hw;
  const int hrow = w + 2, hp = (th + 2) * hrow;
  const int cmp = padded(cm), cinp = padded(cin);
  const int k2 = (cm + 15) / 16, kp = (cin + 15) / 16;
  bf16* y1h = reinterpret_cast<bf16*>(smem_mma);   // [hp][cmp]
  bf16* w2s = y1h + hp * cmp;                        // [9][cm][cmp]
  bf16* y2s = w2s + 9 * cm * cmp;                    // [mt * 16][cmp]
  bf16* w3s = y2s + mt * 16 * cmp;                   // [cout][cmp]
  bf16* xs = w3s + cout * cmp;                       // [mt * 16][cinp]
  bf16* wps = xs + mt * 16 * cinp;                   // [cout][cinp]
  auto base = [&](int c) {
    return ((int64_t)n * c * tlen + t) * hw + (int64_t)y0 * w;
  };
  const int64_t y1_base = base(cm), x_base = base(cin), out_base = base(cout);
  const bf16 zero = __float2bfloat16(0.f);

  copy16(w2s, w2b, 9 * cm * cmp);
  copy16(w3s, w3b, cout * cmp);
  if (PROJ) copy16(wps, wpb, cout * cinp);
  // the y1 halo tile, channels-last; zero outside the frame and past cm
  for (int i = threadIdx.x; i < k2 * 16 * hp; i += blockDim.x) {
    const int c = i / hp, r = i % hp;
    const int gy = y0 - 1 + r / hrow, gx = r % hrow - 1;
    bf16 v = zero;
    if (c < cm && gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = y1[y1_base + c * plane + (int64_t)(gy - y0) * w + gx];
    y1h[r * cmp + c] = v;
  }
  // y2's columns past cm are conv3's zero padding
  const int y2pad = k2 * 16 - cm;
  for (int i = threadIdx.x; i < mt * 16 * y2pad; i += blockDim.x)
    y2s[(i / y2pad) * cmp + cm + i % y2pad] = zero;
  if (PROJ) {
    for (int i = threadIdx.x; i < kp * 16 * mt * 16; i += blockDim.x) {
      const int c = i / (mt * 16), p = i % (mt * 16);
      xs[p * cinp + c] =
          c < cin && p < npix ? x[x_base + c * plane + p] : zero;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  // this lane's ldmatrix row: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int nwarps = blockDim.x / 32;
  for (int m = warp; m < mt; m += nwarps) {
    // conv2: rows past the tile's pixels read a valid pixel, never stored
    const int p = min(m * 16 + lrow, npix - 1);
    const int py = p / w, px = p % w;
    float acc[CM / 8][4];
#pragma unroll
    for (int j = 0; j < CM / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* arow =
          y1h + ((py + tap / 3) * hrow + px + tap % 3) * cmp + lk;
      const bf16* brow = w2s + (tap * cm + g) * cmp + 2 * qd;
      for (int ks = 0; ks < k2; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, arow + ks * 16);
#pragma unroll
        for (int j = 0; j < CM / 8; ++j) {
          if (j * 8 < cm) {
            const bf16* b = brow + j * 8 * cmp + ks * 16;
            mma_bf16(acc[j], a, ld_pair(b), ld_pair(b + 8));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CM / 8; ++j) {
      const int co = j * 8 + 2 * qd;
      if (co < cm) {
        const float s0 = a2[co], s1 = a2[co + 1];
        const float b0 = a2[cm + co], b1 = a2[cm + co + 1];
        bf16* row = y2s + (m * 16 + g) * cmp + co;
        *reinterpret_cast<uint32_t*>(row) =
            pack_pair(fmaxf(fmaf(acc[j][0], s0, b0), 0.f),
                      fmaxf(fmaf(acc[j][1], s1, b1), 0.f));
        *reinterpret_cast<uint32_t*>(row + 8 * cmp) =
            pack_pair(fmaxf(fmaf(acc[j][2], s0, b0), 0.f),
                      fmaxf(fmaf(acc[j][3], s1, b1), 0.f));
      }
    }
    __syncwarp();

    // conv3 (+ projection), 32 output channels at a time
    const bf16* y2row = y2s + (m * 16 + lrow) * cmp + lk;
    const bf16* xrow = xs + (m * 16 + lrow) * cinp + lk;
    for (int o0 = 0; o0 < cout; o0 += 32) {
      float acc3[4][4], accp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc3[j][e] = accp[j][e] = 0.f;
      for (int ks = 0; ks < k2; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, y2row + ks * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (o0 + j * 8 < cout) {
            const bf16* b = w3s + (o0 + j * 8 + g) * cmp + ks * 16 + 2 * qd;
            mma_bf16(acc3[j], a, ld_pair(b), ld_pair(b + 8));
          }
        }
      }
      if (PROJ) {
        for (int ks = 0; ks < kp; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, xrow + ks * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (o0 + j * 8 < cout) {
              const bf16* b =
                  wps + (o0 + j * 8 + g) * cinp + ks * 16 + 2 * qd;
              mma_bf16(accp[j], a, ld_pair(b), ld_pair(b + 8));
            }
          }
        }
      }
      // the epilogue: rows g and g + 8 are pixels, columns 2 qd and + 1
      // output channels
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = o0 + j * 8 + 2 * qd;
        if (co >= cout) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pp = m * 16 + g + 8 * half;
          if (pp >= npix) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = co + e;
            const float r =
                PROJ ? fmaf(accp[j][2 * half + e], ap[c], ap[cout + c])
                     : __bfloat162float(x[x_base + c * plane + pp]);
            const float v = fmaf(acc3[j][2 * half + e], a3[c], a3[cout + c]);
            out[out_base + c * plane + pp] =
                __float2bfloat16(fmaxf(v + r, 0.f));
          }
        }
      }
    }
  }
}

// Rows per tile of the tensor-core path (about 256 pixels, fewer where the
// tile does not fit), or 0 where it does not apply.
int mma_rows(int h, int w, int cm, int cin, int cout, bool proj) {
  if (cm % 8 || cm > 64 || cout % 8 || cin % 8 || w > 256) return 0;
  int th = h < 256 / w ? h : 256 / w;
  if (th < 1) th = 1;
  while (th > 1 && mma_smem_bytes(th, w, cm, cin, cout, proj) > kMaxSmem)
    --th;
  if (mma_smem_bytes(th, w, cm, cin, cout, proj) > kMaxSmem) return 0;
  const int tiles = (h + th - 1) / th;
  return (h + tiles - 1) / tiles;
}

template <int CM, bool PROJ>
cudaError_t launch_mma(const void* y1, const void* x, const void* w2b,
                       const float* a2, const void* w3b, const float* a3,
                       const void* wpb, const float* ap, void* out, int n,
                       int tlen, int h, int w, int cm, int cin, int cout,
                       int th, cudaStream_t stream) {
  const int tiles = (h + th - 1) / th;
  const int64_t blocks = (int64_t)n * tlen * tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int mt = (th * w + 15) / 16;
  const int threads = 32 * (mt < kMmaWarps ? mt : kMmaWarps);
  const size_t smem = mma_smem_bytes(th, w, cm, cin, cout, PROJ);
  auto kernel = fused_bottleneck_tail_mma_kernel<CM, PROJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const bf16*>(y1), static_cast<const bf16*>(x),
      static_cast<const bf16*>(w2b), a2, static_cast<const bf16*>(w3b), a3,
      static_cast<const bf16*>(wpb), ap, static_cast<bf16*>(out), tlen, h, w,
      cm, cin, cout, th, tiles);
  return cudaGetLastError();
}

template <bool PROJ>
cudaError_t launch_mma_cm(const void* y1, const void* x, const void* w2b,
                          const float* a2, const void* w3b, const float* a3,
                          const void* wpb, const float* ap, void* out, int n,
                          int tlen, int h, int w, int cm, int cin, int cout,
                          int th, cudaStream_t s) {
#define PT_LAUNCH_MMA(CM)                                                    \
  return launch_mma<CM, PROJ>(y1, x, w2b, a2, w3b, a3, wpb, ap, out, n, tlen, \
                              h, w, cm, cin, cout, th, s)
  if (cm <= 8) PT_LAUNCH_MMA(8);
  if (cm <= 16) PT_LAUNCH_MMA(16);
  if (cm <= 32) PT_LAUNCH_MMA(32);
  PT_LAUNCH_MMA(64);
#undef PT_LAUNCH_MMA
}

// ---------------------------------------------------------------------------
// The bf16 path for Hopper: TMA loads, 16-byte staging and stores, a
// persistent block with a 2-stage ring. Replaces the TPU kernel `_kernel`
// (pretorched_tpu/ops/pallas/fused_block.py:69) at the shapes of the
// tensor-core path above where T * H * W is a multiple of 8 (16-byte
// aligned channel planes), Cout <= 64 and the plan below fits two blocks an
// SM: SlowFast's fast pathway at res2 and res3, 6 of the slice's 11 tails a
// forward (res4's 5 stay on mma.sync; see "Where it applies").
//
// What bounds it: bytes. At fast res2.1-2 (20 x 32 frames of 56 x 56, Cin =
// Cout = 32, Cm = 8) the tail moves 2 (Cm + Cin + Cout) = 144 bytes a pixel
// and does ~2.2 kFLOP of products a pixel (bf16 tensor cores): 0.086 ms of
// bytes against 0.008 ms of operations. The mma.sync kernel above loads its
// tiles with 2-byte scalar loads into channels-last shared memory, writes
// the output 2 bytes at a time, copies the weights again for every tile and
// never overlaps a tile's loads with its products.
//
// Design. Each block loads the padded weights once and walks over tiles
// (TH full-width rows of one frame, at most 256 pixels) blockIdx.x,
// + gridDim.x, ...; the grid is what the occupancy calculator allows on the
// card's SMs. One thread issues a tile's TMA loads two tiles ahead, into a
// 2-slot ring completing on mbarriers, so the next tile's loads run under
// this tile's products and stores. The tensor maps see y1 and x as 2-D
// (T * H * W, N * C): a box is 128 consecutive pixels of a channel plane by
// all C channels, started at the 8-pixel boundary below the tile (so every
// shared and global 16-byte group lines up); boxes past the tensor read
// zeros, and halo rows outside the frame are zeroed while staging. A tile:
//   1. y1 (and x with a projection) from the boxes (channels-first) into
//      the channels-last tiles of the mma.sync path, 8 channels x 8 pixels
//      a thread: eight 16-byte loads, a register transpose, eight 16-byte
//      stores; the one-pixel column halo stays zero from the start;
//   2. conv2, BN2, ReLU, the rounding to bf16, conv3 (and the projection)
//      on mma.sync as above (Cm is 8-32 on the path: far below the 64-row
//      tiles that would make wgmma pay);
//   3. BN3, the residual and the ReLU into a channels-first output tile in
//      the ring slot (in place over x for the identity residual: each
//      element is read, then written, by the same thread);
//   4. the output tile to device memory, 16 bytes a thread, the threads of
//      a warp on consecutive groups of a channel plane.
// Where it applies. The plan keeps two blocks on an SM, so that one
// block's loads, staging and stores run beside the other's products, and
// Cout is at most 64: the output's pass through shared memory grows with
// Cout, and at fast res4 (Cout = 128) the kernel lost to mma.sync's with
// one block an SM and with two (PERF.md), so those shapes keep it.
// Shared memory at fast res2.1-2 (TH = 4 of 56: 224 pixels): the ring
// 2 x (3 y1 boxes x 8 ch + 2 x boxes x 32 ch) x 256 bytes = 44 KB, the y1
// halo tile 17 KB, y2 11 KB, weights 5 KB: 77 KB.
// ptxas on the H100 build: 64-128 registers and no spills for the identity
// tails, 128 registers and 80-104 bytes of spill for the projection ones
// (chip_smoke.py's phase 2 prints the report).
constexpr int kBox = 128;                      // pixels of a TMA box
constexpr int kTmaThreads = 256;
constexpr int kTmaMaxCout = 64;
constexpr size_t kTwoBlocksSmem = 110 * 1024;  // two blocks an SM

__host__ __device__ __forceinline__ int y1_boxes(int th, int w) {
  return ((th + 2) * w + 7 + kBox - 1) / kBox;
}
__host__ __device__ __forceinline__ int x_boxes(int th, int w) {
  return (th * w + 7 + kBox - 1) / kBox;
}

// Bytes of one ring slot: the y1 boxes, the x boxes and, with a projection,
// the output tile.
__host__ __device__ __forceinline__ int slot_bytes(int th, int w, int cm,
                                                   int cin, int cout,
                                                   bool proj) {
  return kBox * 2 * (y1_boxes(th, w) * cm +
                     x_boxes(th, w) * (cin + (proj ? cout : 0)));
}

size_t tma_smem_bytes(int th, int w, int cm, int cin, int cout, bool proj) {
  const size_t mt16 = (size_t)(th * w + 15) / 16 * 16;
  const size_t cmp = padded(cm), cinp = padded(cin);
  size_t elems = 9 * (size_t)cm * cmp + (size_t)cout * cmp   // w2, w3
                 + (size_t)(th + 2) * (w + 2) * cmp          // y1 halo tile
                 + mt16 * cmp;                               // y2 tile
  if (proj) elems += (size_t)cout * cinp + mt16 * cinp;     // wp, x tile
  return 2 * (size_t)slot_bytes(th, w, cm, cin, cout, proj) +
         elems * sizeof(bf16) + 2 * sizeof(uint64_t) + 128;
}

// Rows per tile of the TMA path, or 0 where it does not apply: the most
// rows (at most 256 pixels) whose plan lets two blocks share an SM, spread
// evenly over the frame's tiles.
int tma_rows(int t, int h, int w, int cm, int cin, int cout, bool proj) {
  if (mma_rows(h, w, cm, cin, cout, proj) < 1) return 0;
  if ((int64_t)t * h * w % 8 || (int64_t)t * h * w >= (1ll << 31) ||
      cin > 256 || cout > kTmaMaxCout)
    return 0;
  const int top = h < 256 / w ? h : 256 / w;
  for (int th = top; th >= 1; --th) {
    if (tma_smem_bytes(th, w, cm, cin, cout, proj) <= kTwoBlocksSmem) {
      const int tiles = (h + th - 1) / th;
      return (h + tiles - 1) / tiles;
    }
  }
  return 0;
}

// The map of a contiguous bf16 tensor of `planes` channel planes of `len`
// pixels (len % 8 == 0), boxes of kBox pixels x `chans` planes, no swizzle.
bool plane_map(CUtensorMap* map, const void* base, int64_t len, int planes,
               int chans) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)len, (cuuint64_t)planes};
  const cuuint64_t strides[1] = {(cuuint64_t)len * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)chans};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// Element (channel c, slot position q) of a tile held as kBox-pixel boxes
// of `chans` channels.
__device__ __forceinline__ int box_index(int q, int c, int chans) {
  return (q / kBox) * chans * kBox + c * kBox + q % kBox;
}

// Eight channels c8 * 8 .. + 7 at the eight slot positions q8 * 8 .. + 7 of
// a box tile, as eight 16-byte rows, one per position: v[e] holds the
// channels of position q8 * 8 + e.
__device__ __forceinline__ void load_transposed(Pack8 (&v)[8], const bf16* tile,
                                                int chans, int c8, int q8) {
  Pack8 a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i].u = *reinterpret_cast<const uint4*>(
        tile + box_index(q8 * 8, c8 * 8 + i, chans));
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[e].h[i] = a[i].h[e];
}

// y1 (n, cm, t, h, w), x (n, cin, t, h, w), out (n, cout, t, h, w) bf16,
// through y1map and xmap (plane_map); weights as for the mma.sync path.
template <int CM, bool PROJ>
__global__ void __launch_bounds__(kTmaThreads)
fused_bottleneck_tail_tma_kernel(const __grid_constant__ CUtensorMap y1map,
                                 const __grid_constant__ CUtensorMap xmap,
                                 const bf16* __restrict__ w2b,
                                 const float* __restrict__ a2,
                                 const bf16* __restrict__ w3b,
                                 const float* __restrict__ a3,
                                 const bf16* __restrict__ wpb,
                                 const float* __restrict__ ap,
                                 bf16* __restrict__ out, int tlen, int h,
                                 int w, int cm, int cin, int cout, int th,
                                 int tiles, int total) {
  extern __shared__ unsigned char smem_tma[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 127) & ~uintptr_t(127));
  const int hw = h * w;
  const int64_t thw = (int64_t)tlen * hw;
  const int hrow = w + 2, hp = (th + 2) * hrow;
  const int mt = (th * w + 15) / 16;
  const int cmp = padded(cm), cinp = padded(cin);
  const int k2 = (cm + 15) / 16, kp = (cin + 15) / 16;
  const int nby = y1_boxes(th, w), nbx = x_boxes(th, w);
  const int ybytes = nby * cm * kBox * 2, xbytes = nbx * cin * kBox * 2;
  const int sbytes = slot_bytes(th, w, cm, cin, cout, PROJ);
  bf16* w2s = reinterpret_cast<bf16*>(ring + 2 * sbytes);   // [9][cm][cmp]
  bf16* w3s = w2s + 9 * cm * cmp;                           // [cout][cmp]
  bf16* wps = w3s + cout * cmp;                             // [cout][cinp]
  bf16* y1h = wps + (PROJ ? cout * cinp : 0);               // [hp][cmp]
  bf16* y2s = y1h + hp * cmp;                               // [mt * 16][cmp]
  bf16* xs = y2s + mt * 16 * cmp;                           // [mt * 16][cinp]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + (PROJ ? mt * 16 * cinp : 0));

  // the tile's frame, first row and rows; its first pixel in the plane
  struct Tile { int ni, y0, rows, g0; };
  auto tile_at = [&](int i) {
    const int frame = i / tiles, y0 = (i % tiles) * th;
    return Tile{frame / tlen, y0, min(th, h - y0), (frame % tlen) * hw + y0 * w};
  };
  auto issue = [&](int k, int i) {
    const Tile tl = tile_at(i);
    unsigned char* slot = ring + (k & 1) * sbytes;
    uint64_t* bar = &full[k & 1];
    mbar_expect_tx(bar, ybytes + xbytes);
    const int ys0 = (tl.g0 - w) & ~7, xs0 = tl.g0 & ~7;
    for (int b = 0; b < nby; ++b)
      tma_load_2d(slot + b * cm * kBox * 2, &y1map, bar, ys0 + b * kBox,
                  tl.ni * cm);
    for (int b = 0; b < nbx; ++b)
      tma_load_2d(slot + ybytes + b * cin * kBox * 2, &xmap, bar,
                  xs0 + b * kBox, tl.ni * cin);
  };

  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    issue(0, blockIdx.x);
    if ((int)(blockIdx.x + gridDim.x) < total) issue(1, blockIdx.x + gridDim.x);
  }
  // the weights once; zeros where the tiles are padded (the halo columns,
  // channels past cm and cin) and stay so
  copy16(w2s, w2b, 9 * cm * cmp);
  copy16(w3s, w3b, cout * cmp);
  if (PROJ) copy16(wps, wpb, cout * cinp);
  {
    uint4* z = reinterpret_cast<uint4*>(y1h);
    const int nz = (hp * cmp + mt * 16 * cmp + (PROJ ? mt * 16 * cinp : 0)) / 8;
    for (int i = threadIdx.x; i < nz; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  for (int k = 0, i = blockIdx.x; i < total; ++k, i += gridDim.x) {
    const Tile tl = tile_at(i);
    const int npix = tl.rows * w;
    const int sy = (tl.g0 - w) - ((tl.g0 - w) & ~7), sx = tl.g0 & 7;
    const int xs0 = tl.g0 - sx;
    unsigned char* slot = ring + (k & 1) * sbytes;
    const bf16* ybuf = reinterpret_cast<const bf16*>(slot);
    bf16* xbuf = reinterpret_cast<bf16*>(slot + ybytes);
    bf16* obuf = PROJ ? reinterpret_cast<bf16*>(slot + ybytes + xbytes) : xbuf;
    mbar_wait(&full[k & 1], (k >> 1) & 1);

    // 1. y1 -> the channels-last halo tile; rows outside the frame zero
    const int run = (tl.rows + 2) * w;
    const int yg = (sy + run + 7) / 8, c8y = cm / 8;
    for (int e8 = threadIdx.x; e8 < yg * c8y; e8 += blockDim.x) {
      const int c8 = e8 % c8y, q8 = e8 / c8y;
      Pack8 v[8];
      load_transposed(v, ybuf, cm, c8, q8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = q8 * 8 + e - sy;     // position in the run
        if (j < 0 || j >= run) continue;
        const int r = j / w, x = j % w, gy = tl.y0 - 1 + r;
        *reinterpret_cast<uint4*>(y1h + (r * hrow + x + 1) * cmp + c8 * 8) =
            gy >= 0 && gy < h ? v[e].u : zero16;
      }
    }
    if (PROJ) {   // x -> the channels-last x tile
      const int xg = (sx + npix + 7) / 8, c8x = cin / 8;
      for (int e8 = threadIdx.x; e8 < xg * c8x; e8 += blockDim.x) {
        const int c8 = e8 % c8x, q8 = e8 / c8x;
        Pack8 v[8];
        load_transposed(v, xbuf, cin, c8, q8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int p = q8 * 8 + e - sx;
          if (p >= 0 && p < npix)
            *reinterpret_cast<uint4*>(xs + p * cinp + c8 * 8) = v[e].u;
        }
      }
    }
    __syncthreads();

    // 2. conv2 and conv3 (+ projection) as mma.sync's. Where registers
    // allow (Cm <= 16, identity residual), a warp takes two 16-pixel tiles
    // at once (m and m + 8): their products interleave, so one tile's
    // chain of 9 k2 dependent mmas runs under the other's, each tile's sums
    // in the same order as one at a time. (With the projection or Cm = 32
    // the second tile's registers made the kernel slower: PERF.md.)
    constexpr int kWarps = kTmaThreads / 32;
    constexpr int NT = CM <= 16 && !PROJ ? 2 : 1;
    for (int m0 = warp; m0 < mt; m0 += NT * kWarps) {
      const int nt = NT == 2 && m0 + kWarps < mt ? 2 : 1;
      const bf16* arow[NT];
      float acc[NT][CM / 8][4];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int p = min((m0 + u * kWarps) * 16 + lrow, npix - 1);
        arow[u] = y1h + ((p / w) * hrow + p % w) * cmp + lk;
#pragma unroll
        for (int j = 0; j < CM / 8; ++j)
          acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
      }
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = ((tap / 3) * hrow + tap % 3) * cmp;
        const bf16* brow = w2s + (tap * cm + g) * cmp + 2 * qd;
        for (int ks = 0; ks < k2; ++ks) {
          uint32_t a[NT][4];
#pragma unroll
          for (int u = 0; u < NT; ++u)
            if (u < nt) ldsm_x4(a[u], arow[u] + shift + ks * 16);
#pragma unroll
          for (int j = 0; j < CM / 8; ++j) {
            if (j * 8 < cm) {
              const bf16* b = brow + j * 8 * cmp + ks * 16;
              const uint32_t b0 = ld_pair(b), b1 = ld_pair(b + 8);
#pragma unroll
              for (int u = 0; u < NT; ++u)
                if (u < nt) mma_bf16(acc[u][j], a[u], b0, b1);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        if (u >= nt) break;
#pragma unroll
        for (int j = 0; j < CM / 8; ++j) {
          const int co = j * 8 + 2 * qd;
          if (co < cm) {
            const float s0 = a2[co], s1 = a2[co + 1];
            const float b0 = a2[cm + co], b1 = a2[cm + co + 1];
            bf16* row = y2s + ((m0 + u * kWarps) * 16 + g) * cmp + co;
            *reinterpret_cast<uint32_t*>(row) =
                pack_pair(fmaxf(fmaf(acc[u][j][0], s0, b0), 0.f),
                          fmaxf(fmaf(acc[u][j][1], s1, b1), 0.f));
            *reinterpret_cast<uint32_t*>(row + 8 * cmp) =
                pack_pair(fmaxf(fmaf(acc[u][j][2], s0, b0), 0.f),
                          fmaxf(fmaf(acc[u][j][3], s1, b1), 0.f));
          }
        }
      }
      __syncwarp();

      for (int o0 = 0; o0 < cout; o0 += 32) {
        float acc3[NT][4][4], accp[NT][4][4];
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc3[u][j][e] = accp[u][j][e] = 0.f;
        for (int ks = 0; ks < k2; ++ks) {
          uint32_t a[NT][4];
#pragma unroll
          for (int u = 0; u < NT; ++u)
            if (u < nt)
              ldsm_x4(a[u], y2s + ((m0 + u * kWarps) * 16 + lrow) * cmp + lk +
                                ks * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (o0 + j * 8 < cout) {
              const bf16* b = w3s + (o0 + j * 8 + g) * cmp + ks * 16 + 2 * qd;
              const uint32_t b0 = ld_pair(b), b1 = ld_pair(b + 8);
#pragma unroll
              for (int u = 0; u < NT; ++u)
                if (u < nt) mma_bf16(acc3[u][j], a[u], b0, b1);
            }
          }
        }
        if (PROJ) {
          for (int ks = 0; ks < kp; ++ks) {
            uint32_t a[NT][4];
#pragma unroll
            for (int u = 0; u < NT; ++u)
              if (u < nt)
                ldsm_x4(a[u], xs + ((m0 + u * kWarps) * 16 + lrow) * cinp +
                                  lk + ks * 16);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (o0 + j * 8 < cout) {
                const bf16* b =
                    wps + (o0 + j * 8 + g) * cinp + ks * 16 + 2 * qd;
                const uint32_t b0 = ld_pair(b), b1 = ld_pair(b + 8);
#pragma unroll
                for (int u = 0; u < NT; ++u)
                  if (u < nt) mma_bf16(accp[u][j], a[u], b0, b1);
              }
            }
          }
        }
        // 3. the epilogue into the channels-first output tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = o0 + j * 8 + 2 * qd;
          if (co >= cout) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = co + e;
            const float s3 = a3[c], b3 = a3[cout + c];
            const float sp = PROJ ? ap[c] : 0.f, bp = PROJ ? ap[cout + c] : 0.f;
#pragma unroll
            for (int u = 0; u < NT; ++u) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int pp = (m0 + u * kWarps) * 16 + g + 8 * half;
                if (u >= nt || pp >= npix) continue;
                const int at = box_index(pp + sx, c, cout);
                const float r =
                    PROJ ? fmaf(accp[u][j][2 * half + e], sp, bp)
                         : __bfloat162float(xbuf[at]);
                const float v = fmaf(acc3[u][j][2 * half + e], s3, b3);
                obuf[at] = __float2bfloat16(fmaxf(v + r, 0.f));
              }
            }
          }
        }
      }
    }
    __syncthreads();

    // 4. the output tile to device memory, 16 bytes a thread where all 8
    // positions lie in the tile
    const int og = (sx + npix + 7) / 8;
    for (int e8 = threadIdx.x; e8 < cout * og; e8 += blockDim.x) {
      const int c = e8 / og, q = (e8 % og) * 8;
      const bf16* src = obuf + box_index(q, c, cout);
      bf16* dst = out + ((int64_t)tl.ni * cout + c) * thw + xs0 + q;
      if (q >= sx && q + 8 <= sx + npix) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8; ++e)
          if (q + e >= sx && q + e < sx + npix) dst[e] = src[e];
      }
    }
    // this slot's reads and writes are done before TMA refills it
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0 && i + 2 * (int)gridDim.x < total)
      issue(k + 2, i + 2 * gridDim.x);
  }
}

int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int CM, bool PROJ>
cudaError_t launch_tma(const void* y1, const void* x, const void* w2b,
                       const float* a2, const void* w3b, const float* a3,
                       const void* wpb, const float* ap, void* out, int n,
                       int tlen, int h, int w, int cm, int cin, int cout,
                       int th, cudaStream_t stream) {
  const int tiles = (h + th - 1) / th;
  const int64_t total = (int64_t)n * tlen * tiles;
  if (total > 0x7fffffff || (int64_t)n * (cm > cin ? cm : cin) > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t thw = (int64_t)tlen * h * w;
  CUtensorMap ym, xm;
  if (!plane_map(&ym, y1, thw, n * cm, cm) ||
      !plane_map(&xm, x, thw, n * cin, cin))
    return cudaErrorNotSupported;
  const size_t smem = tma_smem_bytes(th, w, cm, cin, cout, PROJ);
  auto kernel = fused_bottleneck_tail_tma_kernel<CM, PROJ>;
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTmaThreads, smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (blocks > total) blocks = total;
  if (blocks < 1) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTmaThreads, smem, stream>>>(
      ym, xm, static_cast<const bf16*>(w2b), a2,
      static_cast<const bf16*>(w3b), a3, static_cast<const bf16*>(wpb), ap,
      static_cast<bf16*>(out), tlen, h, w, cm, cin, cout, th, tiles,
      (int)total);
  return cudaGetLastError();
}

template <bool PROJ>
cudaError_t launch_tma_cm(const void* y1, const void* x, const void* w2b,
                          const float* a2, const void* w3b, const float* a3,
                          const void* wpb, const float* ap, void* out, int n,
                          int tlen, int h, int w, int cm, int cin, int cout,
                          int th, cudaStream_t s) {
#define PT_LAUNCH_TMA(CM)                                                    \
  return launch_tma<CM, PROJ>(y1, x, w2b, a2, w3b, a3, wpb, ap, out, n, tlen, \
                              h, w, cm, cin, cout, th, s)
  if (cm <= 8) PT_LAUNCH_TMA(8);
  if (cm <= 16) PT_LAUNCH_TMA(16);
  if (cm <= 32) PT_LAUNCH_TMA(32);
  PT_LAUNCH_TMA(64);
#undef PT_LAUNCH_TMA
}

}  // namespace

extern "C" {

// The chunk widths the weight layouts are padded to: conv2's output dim to
// a multiple of pt_fused_bottleneck_tail_cm_chunk(cm), conv3's and the
// projection's to a multiple of pt_fused_bottleneck_tail_cout_chunk().
int pt_fused_bottleneck_tail_cm_chunk(int cm) {
  return cm <= 8 ? 8 : cm <= 16 ? 16 : 32;
}

int pt_fused_bottleneck_tail_cout_chunk() { return kCO3; }

// The tensor-core path for bf16: its rows per tile where it applies (> 0),
// else 0 (then pt_fused_bottleneck_tail takes the shape). Its weights are
// bf16, channel dims padded to pt_fused_bottleneck_tail_mma_padded(c).
int pt_fused_bottleneck_tail_mma_rows(int h, int w, int cm, int cin, int cout,
                                      int proj) {
  if (h < 1 || w < 1 || cm < 1 || cin < 1 || cout < 1) return 0;
  return mma_rows(h, w, cm, cin, cout, proj != 0);
}

int pt_fused_bottleneck_tail_mma_padded(int c) { return padded(c); }

// The TMA path for bf16: its rows per tile where it applies (> 0), else 0
// (then pt_fused_bottleneck_tail_mma_rows decides). Same weights as the
// mma.sync path.
int pt_fused_bottleneck_tail_tma_rows(int t, int h, int w, int cm, int cin,
                                      int cout, int proj) {
  if (t < 1 || h < 1 || w < 1 || cm < 1 || cin < 1 || cout < 1) return 0;
  return tma_rows(t, h, w, cm, cin, cout, proj != 0);
}

// Arguments as pt_fused_bottleneck_tail_mma; y1, x and out 16-byte
// aligned.
int pt_fused_bottleneck_tail_tma(const void* y1, const void* x,
                                 const void* w2b, const void* a2,
                                 const void* w3b, const void* a3,
                                 const void* wpb, const void* ap, void* out,
                                 int n, int t, int h, int w, int cm, int cin,
                                 int cout, void* stream) {
  if (n < 1 || t < 1) return (int)cudaErrorInvalidValue;
  if ((wpb == nullptr) != (ap == nullptr) || (wpb == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  const bool proj = wpb != nullptr;
  const int th = pt_fused_bottleneck_tail_tma_rows(t, h, w, cm, cin, cout,
                                                   proj);
  if (th < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *a2f = static_cast<const float*>(a2),
              *a3f = static_cast<const float*>(a3),
              *apf = static_cast<const float*>(ap);
  if (proj)
    return (int)launch_tma_cm<true>(y1, x, w2b, a2f, w3b, a3f, wpb, apf, out,
                                    n, t, h, w, cm, cin, cout, th, s);
  return (int)launch_tma_cm<false>(y1, x, w2b, a2f, w3b, a3f, wpb, apf, out,
                                   n, t, h, w, cm, cin, cout, th, s);
}

// y1, x, out bf16 as for pt_fused_bottleneck_tail; w2b (9, cm, padded(cm)):
// tap-major, then output channel, then input channel; w3b (cout,
// padded(cm)); wpb (cout, padded(cin)) or null; a2, a3, ap f32 (2, C).
int pt_fused_bottleneck_tail_mma(const void* y1, const void* x,
                                 const void* w2b, const void* a2,
                                 const void* w3b, const void* a3,
                                 const void* wpb, const void* ap, void* out,
                                 int n, int t, int h, int w, int cm, int cin,
                                 int cout, void* stream) {
  if (n < 1 || t < 1) return (int)cudaErrorInvalidValue;
  if ((wpb == nullptr) != (ap == nullptr) || (wpb == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  const bool proj = wpb != nullptr;
  const int th = pt_fused_bottleneck_tail_mma_rows(h, w, cm, cin, cout, proj);
  if (th < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *a2f = static_cast<const float*>(a2),
              *a3f = static_cast<const float*>(a3),
              *apf = static_cast<const float*>(ap);
  if (proj)
    return (int)launch_mma_cm<true>(y1, x, w2b, a2f, w3b, a3f, wpb, apf, out,
                                    n, t, h, w, cm, cin, cout, th, s);
  return (int)launch_mma_cm<false>(y1, x, w2b, a2f, w3b, a3f, wpb, apf, out, n,
                                   t, h, w, cm, cin, cout, th, s);
}

// y1 (n, cm, t, h, w), x (n, cin, t, h, w), out (n, cout, t, h, w):
// contiguous, dtype 0 = float32, 1 = bfloat16. Weights and folded BN in f32
// as described above; wpt and ap null for the identity residual (then cin
// must equal cout). Returns the cudaError_t of the launch (0 = success).
int pt_fused_bottleneck_tail(const void* y1, const void* x, const void* w2t,
                             const void* a2, const void* w3t, const void* a3,
                             const void* wpt, const void* ap, void* out,
                             int n, int t, int h, int w, int cm, int cin,
                             int cout, int dtype, void* stream) {
  if (n < 1 || t < 1 || h < 1 || w < 1 || cm < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  if ((wpt == nullptr) != (ap == nullptr) || (wpt == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *w2f = static_cast<const float*>(w2t),
              *a2f = static_cast<const float*>(a2),
              *w3f = static_cast<const float*>(w3t),
              *a3f = static_cast<const float*>(a3),
              *wpf = static_cast<const float*>(wpt),
              *apf = static_cast<const float*>(ap);
  cudaError_t err;
  if (dtype == 0)
    err = launch_t<float>(y1, x, w2f, a2f, w3f, a3f, wpf, apf, out, n, t, h,
                          w, cm, cin, cout, s);
  else if (dtype == 1)
    err = launch_t<bf16>(y1, x, w2f, a2f, w3f, a3f, wpf, apf, out, n, t, h,
                         w, cm, cin, cout, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
