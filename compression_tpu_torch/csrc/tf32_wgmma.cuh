// What the 3xTF32 convolution kernels (conv3x3.cu, conv_up3x3.cu) for
// NVIDIA Hopper (sm_90a) share: TF32 rounding, mbarriers, TMA loads and the
// tensor maps they read, wgmma with A in registers and B in 128-byte-swizzled
// shared memory, the tiling and its shared-memory rings, and the host launch.
// Each including source is its own translation unit; everything here is
// internal to it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockK = 32;               // fp32 channels in one 128-byte swizzle row
constexpr int kSmemLimit = 232448;
constexpr int kBarrierBytes = 256;

// A CTA computes a tile of 8 rows by 16 columns of one image by kTileN
// output channels: two consumer warpgroups take 4 of the 8 rows each
// (wgmma's M of 64), and a producer warpgroup keeps the TMA loads in flight
// into two rings, A for x's halo of the tile and B for the weight slices.
constexpr int kTileH = 8, kTileW = 16;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kAStages = 2;

// An A stage: the halo's rows of 128 bytes, rounded up to the 1024 bytes a
// 128-byte swizzle repeats over, so that every stage starts at phase 0.
__host__ __device__ constexpr int a_stage_bytes(int halo_h, int halo_w) {
  return (halo_h * halo_w * 128 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int b_stage_bytes(int bn) { return 2 * bn * 128; }  // hi and lo
// The B ring takes what shared memory leaves after the A ring.
__host__ __device__ constexpr int b_stages(int a_stage, int bn) {
  return (kSmemLimit - 1024 - kBarrierBytes - kAStages * a_stage) / b_stage_bytes(bn);
}
__host__ __device__ constexpr int smem_bytes(int a_stage, int bn) {
  return 1024 + kAStages * a_stage + b_stages(a_stage, bn) * b_stage_bytes(bn) + kBarrierBytes;
}

struct Shape {
  int n, h, w, cin, cout;  // of x
  int tiles_h, tiles_w, tiles_n, kblocks;
  long long tiles;
};

// Tile t: output-channel tile fastest, then the columns, the rows and the
// image of the pixel tile.
struct Tile {
  int img, h0, w0, n0;
};
template <int kTileN>
__device__ __forceinline__ Tile tile_of(const Shape& s, long long t) {
  Tile r;
  r.n0 = static_cast<int>(t % s.tiles_n) * kTileN;
  long long p = t / s.tiles_n;
  r.w0 = static_cast<int>(p % s.tiles_w) * kTileW;
  p /= s.tiles_w;
  r.h0 = static_cast<int>(p % s.tiles_h) * kTileH;
  r.img = static_cast<int>(p / s.tiles_h);
  return r;
}

// fn(std::integral_constant<int, i>{}) for i = I, ..., N - 1.
template <int I, int N, typename Fn>
__device__ __forceinline__ void unroll(Fn&& fn) {
  if constexpr (I < N) {
    fn(std::integral_constant<int, I>{});
    unroll<I + 1, N>(fn);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rounds to the nearest TF32 value, ties away from zero (what
// cvt.rna.tf32.f32 gives), in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO). A k-step
// of 8 fp32 inside the row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async
// products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N) {=, +=} A (64 x 8, tf32, registers) * B (8 x N, tf32, shared
// memory, K-major), N = 120 or 64 by d's size; kAccumulate 0 writes d, 1
// adds to it. A's fragment: a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t +
// 4), a[3] (g + 8, t + 4), g = lane / 4 + 16 * warp, t = lane % 4. d's: [4j +
// 2h + e] is (row g + 8h, column 8j + 2t + e).
template <int kAccumulate>
__device__ __forceinline__ void wgmma(float (&d)[60], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kAccumulate));
}

template <int kAccumulate>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kAccumulate));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 the process has
// already loaded (the library is built without linking libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A map of `rank` dims (innermost first) over float32 at `ptr`, with
// `box`, the 128-byte swizzle and zeros outside the tensor.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches `kernel`, of tile width kTileN and a halo of kHaloH x kHaloW
// pixels, on a persistent grid of at most one CTA an SM: x (n, h, w, cin),
// w_hi and w_lo (cout, 3, 3, cin), all float32, contiguous and 16-byte
// aligned; cin and cout multiples of 4. Returns the cudaError_t of the
// launch. Each kernel has an instantiation of its own.
template <int kTileN, int kHaloH, int kHaloW, typename Kernel>
int launch(Kernel kernel, const void* x, const void* w_hi, const void* w_lo, void* out, int n,
           int h, int w, int cin, int cout, void* stream) {
  if (n < 0 || h < 1 || w < 1 || cin < 4 || cout < 4 || cin % 4 || cout % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int a_stage = a_stage_bytes(kHaloH, kHaloW);
  constexpr int smem = smem_bytes(a_stage, kTileN);
  static_assert(smem <= kSmemLimit, "rings exceed shared memory");
  static_assert(b_stages(a_stage, kTileN) >= 2, "the B ring needs two stages");
  static int sms = 0;  // computed once (one device)
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Shape s;
  s.n = n;
  s.h = h;
  s.w = w;
  s.cin = cin;
  s.cout = cout;
  s.tiles_h = (h + kTileH - 1) / kTileH;
  s.tiles_w = (w + kTileW - 1) / kTileW;
  s.tiles_n = (cout + kTileN - 1) / kTileN;
  s.kblocks = (cin + kBlockK - 1) / kBlockK;
  s.tiles = static_cast<long long>(n) * s.tiles_h * s.tiles_w * s.tiles_n;
  CUtensorMap x_map, hi_map, lo_map;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(cin) * 4,
                                   static_cast<cuuint64_t>(w) * cin * 4,
                                   static_cast<cuuint64_t>(h) * w * cin * 4};
  const cuuint32_t x_box[4] = {kBlockK, kHaloW, kHaloH, 1};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin), 9, static_cast<cuuint64_t>(cout)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cin) * 4,
                                   static_cast<cuuint64_t>(cin) * 9 * 4};
  const cuuint32_t w_box[3] = {kBlockK, 1, kTileN};
  if (!encode(&x_map, x, 4, x_dims, x_strides, x_box) ||
      !encode(&hi_map, w_hi, 3, w_dims, w_strides, w_box) ||
      !encode(&lo_map, w_lo, 3, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = s.tiles < sms ? s.tiles : sms;
  kernel<<<static_cast<int>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_map, hi_map, lo_map, static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
