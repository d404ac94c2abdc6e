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
