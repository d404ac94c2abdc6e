// Hopper building blocks shared by the warp-specialised kernels of the
// non-local attention (K1-fwd, K1-dq and K1-dkv, bf16; their wide programs
// of layer 3 too; the f32 K1-fwd, K1-dq and K1-dkv on TF32 wgmma): the TMA
// tensor maps, the mbarrier ring, the wgmma descriptors and products, and
// setmaxnreg.
//
// Shared-memory tiles. Every operand tile is a stack of 64-channel chunks,
// each chunk `rows` rows of 128 bytes (64 bf16), written by TMA with the
// 128-byte swizzle: the 16-byte group j of row r lands at group j ^ (r % 8).
// A chunk starts on a 1024-byte boundary, so each 8-row atom (1024 bytes)
// carries the swizzle phase that wgmma's B128 layout expects.
//
// wgmma descriptors for such a tile (bytes; the fields hold bytes / 16):
// * K-major (the contraction runs along the 64 channels of a row): SBO =
//   1024, the step between 8-row atoms; LBO unused (the 32-byte k-step
//   stays inside one 128-byte row); the k-th k16 step starts 32 k bytes
//   past the chunk, the next chunk's steps at the next chunk.
// * MN-major (the contraction runs down the rows, transpose bit set): SBO
//   = 1024, the step between 8-row groups along K; LBO = the chunk stride,
//   the step between 64-column blocks along N; the k-th k16 step starts
//   16 rows (2048 bytes) further down.
//
// f32 tiles (the TF32 products). A 128-byte row holds 32 f32, so a chunk
// is 32 channels; TMA's 128-byte swizzle moves the 16-byte group j (4 f32)
// of row r to group j ^ (r % 8), the same bytes as in bf16. TF32 wgmma
// (m64nNk8) reads A and B from shared memory K-major only (no transpose
// bit for 32-bit types), and its k8 step is 32 bytes, as bf16's k16 step:
// the K-major descriptors above hold unchanged (SBO = 1024, the k-th step
// 32 k bytes past the chunk).
//
// Accumulators. A warpgroup's m64nN f32 accumulator is N / 2 registers a
// thread; warp w of the group holds rows 16 w .. 16 w + 15 in the
// mma.sync C layout (mma_tiles.cuh) repeated over N / 8 column tiles:
// d[4 t + e] is row 16 w + lane / 4 + 8 (e / 2), column 8 t + 2 (lane % 4)
// + e % 2. The register A operand of a k16 step is the mma.sync A fragment
// of the warp's 16 rows, so c_to_a turns two accumulator tiles into it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

// ------------------------------------------------------------ host: TMA

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is looked up through the runtime once.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess &&
        p != nullptr)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The map of a contiguous tensor (b, rows, cols) of `esize`-byte elements
// as the 3-D tensor (cols, rows, b), boxes of one 128-byte row (128 /
// esize columns) x box_rows rows x 1, 128-byte swizzle. A box past `rows`
// reads zeros and is clipped on store, so a ragged tile never touches the
// next batch item; a box past `cols` likewise. Rows of a multiple of 16
// bytes and a 16-byte aligned base (the callers check both). False on
// failure.
bool make_map_typed(CUtensorMap* map, CUtensorMapDataType type, int esize,
                    const void* base, int b, int rows, int cols,
                    int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esize,
                                 (cuuint64_t)rows * cols * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor's map: boxes of 64 columns. cols % 8 == 0 (K1-fwd's widths
// that are no multiple of 64 read zeros past cols).
bool make_map(CUtensorMap* map, const void* base, int b, int rows, int cols,
              int box_rows) {
  return make_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, b,
                        rows, cols, box_rows);
}

// An f32 tensor's map: boxes of 32 columns. cols % 4 == 0.
bool make_map_f32(CUtensorMap* map, const void* base, int b, int rows,
                  int cols, int box_rows) {
  return make_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, b,
                        rows, cols, box_rows);
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device: `allowed` (the caller's static, one per kernel)
// keeps the largest size set so far, so a warm launch makes no such call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && allowed[dev] >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && cached) allowed[dev] = (int)bytes;
  return err;
}

// ------------------------------------------------------ device: mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" :: "r"(smem_addr(bar)) : "memory");
}

// The producer's arrival, announcing `bytes` that TMA will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A ring of STAGES slots: full[s] completes when slot s has landed (one
// producer arrival plus the TMA bytes), empty[s] when every consumer warp
// has released it. Use n of a slot (tile t: slot t % STAGES, use t /
// STAGES) waits on full with parity n & 1 and, in the producer, on empty
// with parity (n & 1) ^ 1, which passes at once for the first use.
template <int STAGES>
struct Ring {
  uint64_t full[STAGES];
  uint64_t empty[STAGES];

  __device__ __forceinline__ void init(int consumer_warps) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
  }
  __device__ __forceinline__ static int slot(int t) { return t % STAGES; }
  __device__ __forceinline__ static uint32_t parity(int t) {
    return (t / STAGES) & 1;
  }
  __device__ __forceinline__ void wait_full(int t) {
    mbar_wait(&full[slot(t)], parity(t));
  }
  __device__ __forceinline__ void wait_empty(int t) {
    mbar_wait(&empty[slot(t)], parity(t) ^ 1);
  }
  // one arrival per consumer warp, after the warp's wgmma on the slot is
  // complete
  __device__ __forceinline__ void release(int t) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot(t)]);
  }
};

// ----------------------------------------------------------- device: TMA

// Box (c0 .. c0 + 63, r0 .. r0 + box_rows - 1, batch bi) -> dst, completing
// on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         int bi) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(r0), "r"(bi)
      : "memory");
}

// src -> box (c0.., r0.., bi); rows past the tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int r0,
                                          int bi) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
         "r"(r0), "r"(bi)
      : "memory");
}

// Commit this thread's TMA stores and wait until they have read shared
// memory (the block may then exit or reuse it).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA store, wgmma) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of the 4-byte pair (row r, even column c) of a swizzled
// 64-column chunk: the layout TMA reads back on store.
__device__ __forceinline__ uint32_t swizzled_pair(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// Byte offset of the f32 (row r, column c) of a swizzled 32-column f32
// chunk, as TMA would have written it.
__device__ __forceinline__ uint32_t swizzled_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// ------------------------------------------- device: named barriers, regs

// Barrier `id` (1..15; 0 is __syncthreads') over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// --------------------------------------------------------- device: wgmma

// Descriptor of a 128-byte-swizzled tile at shared address `addr` (see the
// note at the top for LBO and SBO).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for every committed wgmma of the warpgroup. The registers a
// product writes or reads are then pinned past the wait (reg_fence), so
// the compiler neither reads an accumulator early nor reuses an A
// register while the tensor cores may still read it.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of the warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 64) = (scale_d ? d : 0) + a (64 x 16) b (16 x 64), both in
// shared memory, K-major (tnspA = tnspB = 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 16) = (scale_d ? d : 0) + a (64 x 16) b (16 x 16), both in
// shared memory, K-major: the score tile of 16 columns
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, 64 x 32
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) = (scale_d ? d : 0) + a (64 x 16, registers) b (16 x 64,
// shared memory, MN-major: tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 256) = (scale_d ? d : 0) + a (64 x 16, registers) b (16 x 256,
// shared memory, MN-major: tnspB = 1); d[j] is the n64 accumulator of
// columns 64 j .. 64 j + 63, as wgmma_rs_n64 would hold it.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[4][32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123,"
      " %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]),
        "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]),
        "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]),
        "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]),
        "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]),
        "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]),
        "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]),
        "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]),
        "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---------------------------------------------- device: TF32 wgmma (f32)

#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) \
  WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), WG_F4(d, i + 12)

// d (64 x 32) = (scale_d ? d : 0) + a (64 x 8) b (8 x 32) in TF32 (the low
// 13 bits of each f32 operand are not read), both in shared memory,
// K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : WG_F16(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, 64 x 64
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : WG_F16(d, 0), WG_F16(d, 16)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, 64 x 96
__device__ __forceinline__ void wgmma_tf32(float (&d)[48], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1;\n"
      "}\n"
      : WG_F16(d, 0), WG_F16(d, 16), WG_F16(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, 64 x 128
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1;\n"
      "}\n"
      : WG_F16(d, 0), WG_F16(d, 16), WG_F16(d, 32), WG_F16(d, 48)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef WG_F16
#undef WG_F4

// d += a b for one k8 step in f32 from three TF32 products, the small
// terms first (lo hi, hi lo, hi hi; see mma_tf32x3): a_hi, a_lo and b_hi,
// b_lo are the shared addresses of the step in the operands' TF32 halves,
// each a K-major 128-byte-swizzled tile. `first`: d starts from zero.
template <int R>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[R], uint32_t a_hi,
                                             uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo, bool first) {
  wgmma_tf32(d, wgmma_desc(a_lo, 16, 1024), wgmma_desc(b_hi, 16, 1024),
             !first);
  wgmma_tf32(d, wgmma_desc(a_hi, 16, 1024), wgmma_desc(b_lo, 16, 1024), 1);
  wgmma_tf32(d, wgmma_desc(a_hi, 16, 1024), wgmma_desc(b_hi, 16, 1024), 1);
}

// ------------------------------------ device: the kernels' shared steps

constexpr int kWThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kWConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The A fragment of k-step j (columns 16 j .. 16 j + 15) of a 64 x N
// accumulator (R = N / 2 registers), rounded to bf16: its column tiles 2 j
// and 2 j + 1, packed as c_to_a packs them.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&s)[R],
                                         int j) {
  a[0] = pack_pair(s[8 * j + 0], s[8 * j + 1]);
  a[1] = pack_pair(s[8 * j + 2], s[8 * j + 3]);
  a[2] = pack_pair(s[8 * j + 4], s[8 * j + 5]);
  a[3] = pack_pair(s[8 * j + 6], s[8 * j + 7]);
}

// acc (nv 64-column chunks) += a b for one k16 step: b is the shared
// address of the step's first row of an MN-major tile whose 64-column
// chunks lie 64 rows (8192 bytes) apart. One m64n256k16 when nv = 4, else
// nv m64n64k16.
__device__ __forceinline__ void rs_product(float (&acc)[4][32],
                                           const uint32_t (&a)[4], uint32_t b,
                                           int nv) {
  if (nv == 4) {
    wgmma_rs_n256(acc, a, wgmma_desc(b, 64 * 128, 1024), 1);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nv) wgmma_rs_n64(acc[j], a, wgmma_desc(b + j * 8192, 0, 1024), 1);
  }
}

// acc (W 64-column chunks) += a b for one k16 step, as rs_product with nv
// = W fixed at compile time: b's chunks lie `lbo` bytes apart (the rows of
// the tile times 128). No branch guards a product: ptxas serializes a
// warpgroup's wgmmas behind one (C7520).
template <int W>
__device__ __forceinline__ void rs_chunks(float (&acc)[W][32],
                                          const uint32_t (&a)[4], uint32_t b,
                                          uint32_t lbo) {
  if constexpr (W == 4) {
    wgmma_rs_n256(acc, a, wgmma_desc(b, lbo, 1024), 1);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      wgmma_rs_n64(acc[j], a, wgmma_desc(b + j * lbo, 0, 1024), 1);
  }
}

// s (64 x N, R = N / 2 registers) = a b^T over nc 64-channel chunks, both
// K-major: a has 64 rows, its chunks a_stride bytes apart; b has N rows,
// its chunks b_stride bytes apart (N rows times 128).
template <int R>
__device__ __forceinline__ void ss_scores(float (&s)[R], uint32_t a,
                                          uint32_t a_stride, uint32_t b,
                                          int nc, uint32_t b_stride = 8192) {
  for (int j = 0; j < nc; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, wgmma_desc(a + j * a_stride + kk * 32, 16, 1024),
               wgmma_desc(b + j * b_stride + kk * 32, 16, 1024),
               (j | kk) != 0);
  }
}

}  // namespace
