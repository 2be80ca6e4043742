// K1: fused GDN / IGDN for NVIDIA Hopper (sm_90a), 3xTF32 on the tensor cores.
//
// Replaces the TPU kernel `fused_gdn` of
// compression_tpu/layers/pallas/gdn_kernel.py (pl.pallas_call at :65, body
// _gdn_kernel at :28). Over the trailing channel axis of x, seen as
// (rows, C) row-major:
//     GDN:  y = x * rsqrt(beta + (x*x) @ gamma)
//     IGDN: y = x * sqrt(beta + (x*x) @ gamma)
// beta (C,) and gamma (C, C) are the effective (reparameterized) parameters;
// gamma[j][i] is the weight of input channel j in output channel i.
//
// Bound on an H100 SXM: per row the kernel reads C floats and writes C, and
// does C*C multiply-adds. On the fp32 CUDA cores (67 TFLOP/s) that work
// bounds any kernel at 1.14 ms per direction for a batch of eight 768x512
// images (1,032,192 rows of C = 192: 76.1 GFLOP, 1.59 GB). Plain TF32 on the
// tensor cores keeps 11 bits, too few for the reference tolerance of 2e-5.
// 3xTF32 keeps about 21: each operand v is split into hi = tf32(v), rounded
// to nearest, and lo = tf32(v - hi), and the product is lo*hi + hi*lo + hi*hi
// (lo*lo is dropped), each term summed in fp32. Every term of (x*x) @ gamma
// is nonnegative, so nothing cancels. Three products at the TF32 rate
// (495 TFLOP/s) take 0.46 ms per direction, the bytes at 3.35 TB/s 0.47 ms:
// the kernel is bound by bytes, barely, and reaches that bound only if the
// loads overlap the products.
//
// Design:
//  * wgmma in tf32 reads B K-major from shared memory, so gamma is staged
//    transposed ([N][K]), split into hi and lo, in the 128-byte swizzled
//    layout wgmma and TMA share (32 fp32 are one 128-byte row). At C = 192
//    gamma's hi + lo (288 KB) exceeds a block's 227 KB, so each CTA keeps one
//    slice of NS = 64 output channels (32 where 64 does not divide C) and S =
//    C / NS CTAs share every x tile. They are neighbours in the grid and walk
//    the same tiles in step, so the tile they all read is an L2 hit for all
//    but the first.
//  * A is x*x, squared and split in registers from the x tile (the RS form
//    of wgmma), so x*x never touches memory; the epilogue takes x from the
//    same tile, so each x tile is read from HBM once.
//  * A persistent grid; two warpgroups per CTA, each with its own x stage
//    (64 rows x C, loaded by TMA as C/32 boxes of 64 x 32 fp32, 128-byte
//    swizzle, one mbarrier). A warpgroup refills its stage with its next
//    tile as soon as all its threads have read x from it, so the load runs
//    under its last products, its epilogue and the other warpgroup's tile.
//  * Per 32-channel K block: the warpgroup builds the block's A fragments,
//    then issues 4 k-steps x 3 products (lo*hi and hi*lo into one
//    accumulator, hi*hi into another), commits, and keeps one block in
//    flight (wait_group 1) while it builds the next. The epilogue adds the
//    two accumulators and beta, applies rsqrtf (IGDN: norm * rsqrtf(norm),
//    not the slower IEEE sqrtf), multiplies by x and stores the row if it
//    exists (TMA zero-fills rows past the end).
//  * A row's result depends only on that row: every row takes the same
//    products in the same order, whatever its tile or place in the tile.
//
// The file also holds fused_gdn_general (below K1), the same function for
// the widths and types K1 does not take, on the tensor cores: float32 as
// split-TF32 wgmma with x streamed through a TMA ring where the rows allow
// it, else through warp-level mma.sync (3xTF32 in float32, one TF32
// product in float16 and bfloat16, DMMA in float64).
//
// C interface (loaded with ctypes): tpc_gdn_forward (K1) and
// tpc_gdn_general_forward return the cudaError_t of the launch (0 on
// success); the wrappers raise otherwise.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileRows = 64;  // wgmma's M
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBlockK = 32;  // fp32 in one 128-byte swizzle row

// Output channels a CTA holds gamma for.
__host__ __device__ constexpr int slice_width(int c) { return c % 64 == 0 ? 64 : 32; }

template <int C>
constexpr int smem_bytes() {
  return 1024                                    // alignment of the swizzled tiles
         + 2 * slice_width(C) * C * 4            // gamma slice, hi and lo
         + kWarpgroups * kTileRows * C * 4       // one x stage per warpgroup
         + kWarpgroups * 8;                      // one mbarrier per stage
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rounds to the nearest TF32 value, ties away from zero (what
// cvt.rna.tf32.f32 gives, in two integer operations where the conversion
// runs at a quarter of their rate); the tensor cores would otherwise drop
// the low 13 bits.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// Rows [tile*64, tile*64 + 64) of x into a stage laid out [C/32][64][32],
// each 64 x 32 box in the 128-byte swizzle.
template <int C>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, float* stage,
                                          uint64_t* bar, int tile) {
  mbar_expect_tx(bar, kTileRows * C * 4);
#pragma unroll
  for (int kb = 0; kb < C / kBlockK; ++kb)
    tma_load_2d(stage + kb * kTileRows * kBlockK, map, bar, kb * kBlockK,
                tile * kTileRows);
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout. A k-step of 8 fp32 inside the
// 128-byte row advances the start address by 32 bytes.
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

// d (64 x N, fp32) += A (64 x 8, tf32, registers) * B (8 x N, tf32, shared
// memory, K-major). A's fragment: a[0] (row g, k t), a[1] (g + 8, t),
// a[2] (g, t + 4), a[3] (g + 8, t + 4), g = lane / 4 + 16 * warp, t = lane % 4.
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <int C, bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
gdn_kernel(const __grid_constant__ CUtensorMap x_map,
           const float* __restrict__ beta, const float* __restrict__ gamma,
           float* __restrict__ out, int rows) {
  constexpr int NS = slice_width(C);  // output channels of this CTA
  constexpr int S = C / NS;           // CTAs sharing each x tile
  constexpr int KB = C / kBlockK;     // 128-byte K blocks

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* g_hi = reinterpret_cast<float*>(base);  // [KB][NS][32], swizzled
  float* g_lo = g_hi + NS * C;
  float* x_s = g_lo + NS * C;  // [kWarpgroups][KB][64][32], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(x_s + kWarpgroups * kTileRows * C);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * (wtid / 32) + g;  // this thread's rows: r0 and r0 + 8
  const int n0 = (blockIdx.x % S) * NS;
  const int stride = (gridDim.x / S) * kWarpgroups;
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  int tile = (blockIdx.x / S) * kWarpgroups + wg;
  float* stage = x_s + wg * kTileRows * C;

  if (tid == 0) {
    for (int w = 0; w < kWarpgroups; ++w) mbar_init(&full[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wtid == 0 && tile < tiles) load_tile<C>(&x_map, stage, &full[wg], tile);

  // gamma's slice, transposed to [n][k] and split, while the first tiles load.
  // A warp takes 8 n by 4 k: 32-byte global reads, and 32 distinct banks.
#pragma unroll 8
  for (int i = tid; i < NS * C; i += kThreads) {
    const int q = i / 32;
    const int n = (q % (NS / 8)) * 8 + (i & 7);
    const int k = (q / (NS / 8)) * 4 + ((i >> 3) & 3);
    const float v = gamma[k * C + n0 + n];
    const uint32_t hi = tf32_rna(v);
    const int off = (k / kBlockK) * NS * kBlockK + n * kBlockK +
                    ((((k % kBlockK) >> 2) ^ (n & 7)) << 2) + (k & 3);
    g_hi[off] = __uint_as_float(hi);
    g_lo[off] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
  float2 b[NS / 8];
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
    b[j] = *reinterpret_cast<const float2*>(beta + n0 + 8 * j + 2 * t);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const uint32_t hi_addr = smem_addr(g_hi);
  const uint32_t lo_addr = smem_addr(g_lo);
  uint32_t phase = 0;
  for (; tile < tiles; tile += stride) {
    mbar_wait(&full[wg], phase);
    phase ^= 1;

    float big[NS / 2], small[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) big[i] = small[i] = 0.f;
    fence_regs(big);
    fence_regs(small);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const float* p0 = stage + kb * kTileRows * kBlockK + r0 * kBlockK + t;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // k = 8s + t and 8s + t + 4: 16-byte chunks 2s and 2s + 1 of the
        // row, swizzled by the row's phase (r0 % 8 == (r0 + 8) % 8 == g).
        const int c0 = ((2 * s) ^ g) << 2;
        const int c1 = ((2 * s + 1) ^ g) << 2;
        const float v[4] = {p0[c0], p0[8 * kBlockK + c0], p0[c1],
                            p0[8 * kBlockK + c1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float sq = v[q] * v[q];
          ahi[s][q] = tf32_rna(sq);
          alo[s][q] = tf32_rna(sq - __uint_as_float(ahi[s][q]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t koff = kb * NS * kBlockK * 4 + s * 32;
        wgmma(small, alo[s], sw128_desc(hi_addr + koff));
        wgmma(small, ahi[s], sw128_desc(lo_addr + koff));
        wgmma(big, ahi[s], sw128_desc(hi_addr + koff));
      }
      wgmma_commit();
      wgmma_wait<1>();
    }

    // x for the epilogue, while the last block's products run.
    float2 xe[NS / 8][2];
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const int c = n % kBlockK;
      const float* p = stage + (n / kBlockK) * kTileRows * kBlockK +
                       r0 * kBlockK + ((((c >> 2) ^ g)) << 2) + (c & 3);
      xe[j][0] = *reinterpret_cast<const float2*>(p);
      xe[j][1] = *reinterpret_cast<const float2*>(p + 8 * kBlockK);
    }
    // Every thread of the warpgroup is done with the stage: refill it.
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (wtid == 0 && tile + stride < tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile<C>(&x_map, stage, &full[wg], tile + stride);
    }
    wgmma_wait<0>();
    fence_regs(big);
    fence_regs(small);

    // Accumulator fragment: [4j + 2h + e] is (row r0 + 8h, col 8j + 2t + e).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile * kTileRows + r0 + 8 * h;
      if (row >= rows) continue;
      float* o = out + static_cast<long long>(row) * C + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const float nx = big[4 * j + 2 * h] + small[4 * j + 2 * h] + b[j].x;
        const float ny = big[4 * j + 2 * h + 1] + small[4 * j + 2 * h + 1] + b[j].y;
        float2 y;
        y.x = xe[j][h].x * (kInverse ? nx * rsqrtf(nx) : rsqrtf(nx));
        y.y = xe[j][h].y * (kInverse ? ny * rsqrtf(ny) : rsqrtf(ny));
        *reinterpret_cast<float2*>(o + 8 * j) = y;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 the process has
// already loaded (the library is built without linking libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

template <int C, bool kInverse>
cudaError_t launch(const float* x, const float* beta, const float* gamma,
                   float* out, long long rows, cudaStream_t stream) {
  constexpr int S = C / slice_width(C);
  constexpr int smem = smem_bytes<C>();
  static_assert(smem <= 232448, "gamma slice and x stages exceed shared memory");
  if (rows > INT_MAX - kTileRows) return cudaErrorInvalidValue;
  const int tiles = static_cast<int>((rows + kTileRows - 1) / kTileRows);
  if (tiles == 0) return cudaSuccess;
  // CTA groups in one wave; computed once per instantiation (one device).
  static int max_groups = 0;
  auto kernel = gdn_kernel<C, kInverse>;
  if (max_groups == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_groups = sms * per_sm / S > 0 ? sms * per_sm / S : 1;
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 4};
  const cuuint32_t box[2] = {kBlockK, kTileRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int need = (tiles + kWarpgroups - 1) / kWarpgroups;
  const int groups = need < max_groups ? need : max_groups;
  kernel<<<groups * S, kThreads, smem, stream>>>(map, beta, gamma, out,
                                                 static_cast<int>(rows));
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const float* x, const float* beta, const float* gamma,
                     float* out, long long rows, int inverse,
                     cudaStream_t stream) {
  return inverse ? launch<C, true>(x, beta, gamma, out, rows, stream)
                 : launch<C, false>(x, beta, gamma, out, rows, stream);
}

// fused_gdn_general: the same function as K1 (the TPU kernel's body,
// _gdn_kernel at compression_tpu/layers/pallas/gdn_kernel.py:28) for every
// input K1 cannot hold: any C >= 1, and x, beta, gamma stored as float,
// double, __half or __nv_bfloat16. The norm is accumulated in float (double
// for double) and y is stored in x's type, as the TPU kernel computes an f32
// norm and casts its output to out_ref's type.
//
// Bound on an H100 SXM: per row it reads C values and writes C, and does C*C
// multiply-adds. At 786,432 rows (the first GDN of a batch of eight 768x512
// images) the products bound float32 (3xTF32 at 495 TFLOP/s: 0.48 ms at
// C = 224, 0.98 ms at C = 320) and float64 (the FP64 tensor cores at 67
// TFLOP/s: 1.54 ms at C = 256); the bytes bound bfloat16 and float16 (0.18
// ms at C = 192, against 0.12 ms for one TF32 product).
//
// Design: two forms, picked in the C entry before the one launch.
// float32 whose rows TMA can stream (C % 4 == 0, x and y 16-byte aligned)
// takes gdn_general_tma_kernel, K1's split-TF32 wgmma with x streamed in K
// blocks (below). Everything else takes gdn_general_kernel: warp-level
// mma.sync, which takes any tile of 16 rows and 8 channels, so any C is a
// matter of zero-filled tails. A CTA of 4 warps (2 along the rows, 2 along
// the output channels, each 64 x 32) owns 128 rows by 64 output channels,
// two CTAs an SM, and walks the input channels in chunks (32 in TF32, 16
// in double):
//  * float32 as 3xTF32, as K1: x*x and gamma are split into hi = tf32(v),
//    rounded to nearest, and lo = tf32(v - hi), and each 8-deep k-step adds
//    lo*hi, hi*lo and hi*hi into one fp32 accumulator (m16n8k8 tf32; lo*lo
//    is dropped, and every term is nonnegative, so nothing cancels);
//  * float16 and bfloat16 as one TF32 product: x is squared in float, never
//    in the 16-bit type (float16 overflows above |x| = 256), and rounded to
//    TF32 (at most 2^-11 of the norm, a fraction of an ulp of y); gamma's 8
//    or 11 significant bits are exact in TF32;
//  * float64 on the FP64 tensor cores (DMMA, m16n8k4), IEEE products and
//    sums.
// Each chunk is loaded into registers, 16 bytes a load where every row
// starts 16-byte aligned and one element otherwise (rows and channels past
// the end load 0, in the kernel: no padded copy), then squared and stored
// to shared memory halfway through the chunk before it (gamma split there
// once); each warp rounds and splits the x*x fragments it reads. The
// registers the stash frees take the next chunk's loads at once, which so
// have a chunk to land. Two shared buffers, one barrier a chunk. The grid
// is persistent over (row tile, channel slice) items, the slices of one row
// tile next to each other, so the CTAs that share an x tile run at once
// and all but the first read it from L2. The epilogue stages the norms
// through the free buffer and walks the tile a row at a time: x read again
// (from L2) and y written by neighbouring threads, beta added, rsqrt
// applied (IGDN: norm * rsqrtf(norm) in float, sqrt in double).
// In both forms every row takes the same products in the same order (k =
// 0..C-1, no split-K), so a row's result does not depend on its tile or
// batch; each launches on the caller's stream and never synchronizes: it
// can be captured in a CUDA graph.
//
// Measured (chip_smoke.py 16b; tools/gdn_general_profile.py; H100 80GB
// HBM3 at 700 W): mma.sync reaches ~310 TFLOP/s in TF32 on this card, 63%
// of wgmma's peak, and DMMA m16n8k4 its full 67 TFLOP/s. The mma.sync form
// spends most of its time outside the products: the stash, the loads'
// issue and the epilogue overlap the tensor cores only in part.
constexpr int kGenThreads = 128;
constexpr int kGenWarpsM = 2;  // warps along the rows; 2 along the channels
constexpr int kGenBM = 128;    // rows a CTA; its output channels, kBN, are the route's
constexpr int kGenCtasPerSm = 2;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_acc(float v);
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_acc<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T from_acc(double v) { return v; }

// V neighbouring elements of T, moved by one load or store: 16 bytes on
// the vector form, one element on the scalar one.
template <typename T, int V>
struct Pack {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  using Word = std::conditional_t<kBytes >= 4, uint32_t, unsigned short>;
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  Word w[kWords];
  __device__ __forceinline__ auto get(int i) const { return to_acc(reinterpret_cast<const T*>(w)[i]); }
  template <typename A>
  __device__ __forceinline__ void set(int i, A v) { reinterpret_cast<T*>(w)[i] = from_acc<T>(v); }
};

// A global load issued where it is written: volatile asm, which the
// compiler keeps in order with the products' (it would otherwise sink a
// staged load down to its use, a chunk later, and wait on it there), and
// predicated: ok false gives zeros and reads nothing.
template <typename T, int V>
__device__ __forceinline__ void load_pack(Pack<T, V>& p, const T* src, bool ok) {
  const int on = ok;
  if constexpr (Pack<T, V>::kBytes == 16) {
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %4, 0;\n"
        "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
        "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%5];\n}\n"
        : "=r"(p.w[0]), "=r"(p.w[1]), "=r"(p.w[2]), "=r"(p.w[3])
        : "r"(on), "l"(src));
  } else if constexpr (Pack<T, V>::kBytes == 8) {
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\nmov.b32 %0, 0;\nmov.b32 %1, 0;\n"
        "@q ld.global.nc.v2.u32 {%0, %1}, [%3];\n}\n"
        : "=r"(p.w[0]), "=r"(p.w[1])
        : "r"(on), "l"(src));
  } else if constexpr (Pack<T, V>::kBytes == 4) {
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %1, 0;\nmov.b32 %0, 0;\n"
        "@q ld.global.nc.u32 %0, [%2];\n}\n"
        : "=r"(p.w[0])
        : "r"(on), "l"(src));
  } else {
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %1, 0;\nmov.b16 %0, 0;\n"
        "@q ld.global.nc.u16 %0, [%2];\n}\n"
        : "=h"(p.w[0])
        : "r"(on), "l"(src));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* dst, const Pack<T, V>& p) {
  using P = Pack<T, V>;
  if constexpr (P::kBytes == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(p.w[0], p.w[1], p.w[2], p.w[3]);
  } else if constexpr (P::kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(p.w[0], p.w[1]);
  } else {
    *reinterpret_cast<typename P::Word*>(dst) = p.w[0];
  }
}

// N values of float or double to (put) and from (take) 16-byte aligned
// shared memory, 16 bytes an access where N allows.
template <int N>
__device__ __forceinline__ void put(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}
template <int N>
__device__ __forceinline__ void put(double* dst, const double (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<double2*>(dst + i) = make_double2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void take(const float* src, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = src[i];
  }
}
template <int N>
__device__ __forceinline__ void take(const double* src, double (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const double2 q = *reinterpret_cast<const double2*>(src + i);
      v[i] = q.x, v[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = src[i];
  }
}

// IGDN in float as norm * rsqrtf(norm), as K1 does, not the IEEE sqrtf (a
// longer sequence with a special-case branch).
__device__ __forceinline__ float norm_scale(float norm, bool inverse) {
  return inverse ? norm * rsqrtf(norm) : rsqrtf(norm);
}
__device__ __forceinline__ double norm_scale(double norm, bool inverse) {
  return inverse ? sqrt(norm) : rsqrt(norm);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

constexpr int max_of(int a, int b) { return a > b ? a : b; }

// The epilogue stages the CTA's norms through shared memory, kEpiRows rows
// a pass, so that x is read and y written a row at a time, the lanes on
// neighbouring channels. Its row stride, kBN + 8 (8 mod 32 words and 8 mod
// 16 doubles), keeps the fragments' paired stores free of bank conflicts.
constexpr int kEpiRows = 64;

// d (16 x 8, fp32) += a (16 x 8, tf32) * b (8 x 8, tf32). a: a[0] (row g,
// k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); b: b[0] (k t,
// col g), b[1] (t + 4, g); d: d[0] (g, 2t), d[1] (g, 2t + 1), d[2] (g + 8,
// 2t), d[3] (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8, fp64) += a (16 x 4) * b (4 x 8): a[0] (row g, k t), a[1]
// (g + 8, t); b (k t, col g); d as mma_tf32's.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Four 8x8 matrices of 16-bit pairs, i.e. of 32-bit values 8 rows by 4: the
// tf32 A fragment of a 16 x 8 tile, each lane giving one row's address.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// What the two routes share: a chunk of kBK input channels of the CTA's
// rows [r0, r0 + kGenBM) of x and of gamma's columns [n0, n0 + kBN),
// fetched V elements a load (pack q of a thread: row (q * kGenThreads +
// tid) / (kBK / V) of x, its neighbours on neighbouring threads; likewise
// for gamma's rows); x is squared when the chunk is stashed.
template <typename T, typename A, int kBK, int kBN, int V>
struct Chunk {
  static constexpr int kXPer = kGenBM * kBK / V / kGenThreads;
  static constexpr int kGPer = kBK * kBN / V / kGenThreads;
  Pack<T, V> x[kXPer], g[kGPer];

  __device__ __forceinline__ void fetch(const T* __restrict__ xs, const T* __restrict__ gamma,
                                        long long rows, int C, long long r0, int n0, int k0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int e = q * kGenThreads + tid;
      const long long row = r0 + e / (kBK / V);
      const int k = k0 + e % (kBK / V) * V;
      load_pack(x[q], xs + row * C + k, row < rows && k < C);
    }
#pragma unroll
    for (int q = 0; q < kGPer; ++q) {
      const int e = q * kGenThreads + tid;
      const int kk = k0 + e / (kBN / V);
      const int n = n0 + e % (kBN / V) * V;
      load_pack(g[q], gamma + static_cast<long long>(kk) * C + n, kk < C && n < C);
    }
  }

  // Calls put_x(offset in a [row][k] tile, x*x values) and put_g(offset in
  // a [k][n] tile, gamma values) for each pack.
  template <int kAStride, int kBStride, typename FX, typename FG>
  __device__ __forceinline__ void each(FX&& put_x, FG&& put_g) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int e = q * kGenThreads + tid;
      A v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const A u = x[q].get(i);
        v[i] = u * u;
      }
      put_x(e / (kBK / V) * kAStride + e % (kBK / V) * V, v);
    }
#pragma unroll
    for (int q = 0; q < kGPer; ++q) {
      const int e = q * kGenThreads + tid;
      A v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = g[q].get(i);
      put_g(e / (kBN / V) * kBStride + e % (kBN / V) * V, v);
    }
  }
};

// The TF32 routes: T = float (3xTF32, kSplit) or a 16-bit type (one
// product). Shared buffer: x*x as [row][k], in float (each warp rounds and
// splits the fragments it reads: the split in shared memory would double
// the A tile's traffic, which the tensor cores' rate nearly saturates),
// then gamma as [k][n], split once (hi, then lo); row strides padded so
// that ldmatrix and the B reads are free of bank conflicts.
template <typename T, int V>
struct Tf32Route {
  using Acc = float;
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int kMT = 4;  // m16 tiles a warp (64 rows)
  static constexpr int kNT = 4;  // n8 tiles a warp (32 channels)
  static constexpr int kWarpRows = 16 * kMT;
  static constexpr int kWarpCols = 8 * kNT;
  static constexpr int kBN = kWarpCols * kGenThreads / 32 / kGenWarpsM;
  static constexpr int kBK = 32;               // input channels a chunk
  static constexpr int kSteps = kBK / 8;       // mma k-steps a chunk
  static constexpr int kAStride = kBK + 4;     // ldmatrix's 8 rows in 8 bank groups
  static constexpr int kBStride = kBN + 8;     // 8 mod 32 words
  static constexpr int kEpiStride = kBN + 8;
  static constexpr int kA = kGenBM * kAStride;
  static constexpr int kB = kBK * kBStride;
  static constexpr int kParts = kSplit ? 2 : 1;  // gamma's
  static constexpr int kBuffer = max_of(kA + kParts * kB, kEpiRows * kEpiStride);  // floats
  static constexpr int kSmem = 2 * kBuffer * 4;

  using Staged = Chunk<T, float, kBK, kBN, V>;
  struct Accum { float v[kMT][kNT][4]; };

  // x*x, and gamma split, into the buffer (16-bit gamma is exact in TF32).
  static __device__ __forceinline__ void stash(const Staged& s, float* buf) {
    float* a = buf;
    float* b = buf + kA;
    s.template each<kAStride, kBStride>(
        [&](int off, const float (&v)[V]) { put(a + off, v); },
        [&](int off, const float (&v)[V]) {
          if constexpr (kSplit) {
            float hi[V], lo[V];
#pragma unroll
            for (int i = 0; i < V; ++i) {
              hi[i] = __uint_as_float(tf32_rna(v[i]));
              lo[i] = __uint_as_float(tf32_rna(v[i] - hi[i]));
            }
            put(b + off, hi);
            put(b + kB + off, lo);
          } else {
            put(b + off, v);
          }
        });
  }

  // k-steps [s0, s1) of the chunk in buf for the warp's 64 x 32 tile at
  // (wr, wc) of the CTA's: lo*hi, hi*lo, then hi*hi, each over all 16
  // accumulator tiles, so that no product waits on the one before it.
  template <int s0, int s1>
  static __device__ __forceinline__ void products(Accum& acc, const float* buf, int wr, int wc) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* a = buf;
    const float* b = buf + kA;
#pragma unroll
    for (int s = s0; s < s1; ++s) {
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* p = b + (8 * s + t) * kBStride + wc + 8 * j + g;
        bh[j][0] = __float_as_uint(p[0]);
        bh[j][1] = __float_as_uint(p[4 * kBStride]);
        if constexpr (kSplit) {
          bl[j][0] = __float_as_uint(p[kB]);
          bl[j][1] = __float_as_uint(p[kB + 4 * kBStride]);
        }
      }
      // Lane l gives the row of matrix l / 8: rows +0..7 or +8..15, k +0 or +4.
      const float* pa = a + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * kAStride +
                        8 * s + (lane >> 4) * 4;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        ldmatrix_x4(ah[i], pa + 16 * i * kAStride);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = __uint_as_float(ah[i][r]);
          ah[i][r] = tf32_rna(v);
          if constexpr (kSplit) al[i][r] = tf32_rna(v - __uint_as_float(ah[i][r]));
        }
      }
      if constexpr (kSplit) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc.v[i][j], al[i], bh[j]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_tf32(acc.v[i][j], ah[i], bl[j]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(acc.v[i][j], ah[i], bh[j]);
    }
  }
};

// The float64 route: DMMA m16n8k4, a warp's 64 x 32 tile as 4 x 4 tiles of
// 16 x 8; x*x and gamma in double in the buffer, row strides padded so that
// each half-warp's 8-byte reads hit 16 distinct bank pairs.
template <int V>
struct F64Route {
  using Acc = double;
  static constexpr int kMT = 4;  // m16 tiles a warp (64 rows)
  static constexpr int kNT = 4;  // n8 tiles a warp (32 channels)
  static constexpr int kWarpRows = 16 * kMT;
  static constexpr int kWarpCols = 8 * kNT;
  static constexpr int kBN = kWarpCols * kGenThreads / 32 / kGenWarpsM;
  static constexpr int kBK = 16;  // at 32, the staged chunk spills registers
  static constexpr int kSteps = kBK / 4;
  static constexpr int kAStride = kBK + 4;     // 4 mod 16 doubles
  static constexpr int kBStride = kBN + 4;     // 4 mod 16 doubles
  static constexpr int kEpiStride = kBN + 8;
  static constexpr int kA = kGenBM * kAStride;
  static constexpr int kB = kBK * kBStride;
  static constexpr int kBuffer = max_of(kA + kB, kEpiRows * kEpiStride);  // doubles
  static constexpr int kSmem = 2 * kBuffer * 8;

  using Staged = Chunk<double, double, kBK, kBN, V>;
  struct Accum { double v[kMT][kNT][4]; };

  static __device__ __forceinline__ void stash(const Staged& s, double* buf) {
    s.template each<kAStride, kBStride>(
        [&](int off, const double (&v)[V]) { put(buf + off, v); },
        [&](int off, const double (&v)[V]) { put(buf + kA + off, v); });
  }

  template <int s0, int s1>
  static __device__ __forceinline__ void products(Accum& acc, const double* buf, int wr,
                                                  int wc) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int s = s0; s < s1; ++s) {
      double a[kMT][2], b[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) b[j] = buf[kA + (4 * s + t) * kBStride + wc + 8 * j + g];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        a[i][0] = buf[(wr + 16 * i + g) * kAStride + 4 * s + t];
        a[i][1] = buf[(wr + 16 * i + 8 + g) * kAStride + 4 * s + t];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_f64(acc.v[i][j], a[i], b[j]);
    }
  }
};

// y for the CTA's tile at (r0, n0). In each pass the warps whose rows lie
// in it store their accumulators (element [i][j][2h + e]: row wr + 16i +
// 8h + g, channel wc + 8j + 2t + e) to the tile in shared memory; then the
// threads walk the pass's rows V channels at a time, neighbouring threads
// on neighbouring channels: x read, beta added, y stored. Packs past the
// end read nothing and store nothing.
template <class R, int V, bool kInverse, typename T>
__device__ __forceinline__ void finish(const typename R::Accum& acc, typename R::Acc* tile,
                                       const T* __restrict__ x, const T* __restrict__ beta,
                                       T* __restrict__ out, long long rows, int C,
                                       long long r0, int n0, int wr, int wc, bool active) {
  using A = typename R::Acc;
  constexpr int kS = R::kEpiStride;
  constexpr int kPerRow = R::kBN / V;  // packs a row
  constexpr int kIters = kEpiRows * kPerRow / kGenThreads;
  constexpr int kBatch = kIters < 4 ? kIters : 4;  // x loads in flight at once
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c = threadIdx.x % kPerRow * V;  // the same channels in every row
  const bool col_ok = n0 + c < C;
  A b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) b[i] = to_acc(beta[col_ok ? n0 + c + i : 0]);
#pragma unroll
  for (int p = 0; p < kGenBM / kEpiRows; ++p) {
    if (active && wr / kEpiRows == p) {
#pragma unroll
      for (int i = 0; i < R::kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < R::kNT; ++j)
            store2(tile + (wr - p * kEpiRows + 16 * i + 8 * h + g) * kS + wc + 8 * j + 2 * t,
                   acc.v[i][j][2 * h], acc.v[i][j][2 * h + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int i0 = 0; i0 < kIters; i0 += kBatch) {
      Pack<T, V> xv[kBatch];
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const long long row =
            r0 + p * kEpiRows + ((i0 + it) * kGenThreads + threadIdx.x) / kPerRow;
        load_pack(xv[it], x + row * C + n0 + c, row < rows && col_ok);
      }
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int r = ((i0 + it) * kGenThreads + threadIdx.x) / kPerRow;
        const long long row = r0 + p * kEpiRows + r;
        A norm[V];
        take(tile + r * kS + c, norm);
        Pack<T, V> y;
#pragma unroll
        for (int i = 0; i < V; ++i)
          y.set(i, xv[it].get(i) * norm_scale(norm[i] + b[i], kInverse));
        if (row < rows && col_ok) store_pack(out + row * C + n0 + c, y);
      }
    }
    __syncthreads();
  }
}

template <typename T, int V> struct RouteOf { using type = Tf32Route<T, V>; };
template <int V> struct RouteOf<double, V> { using type = F64Route<V>; };

// One persistent CTA walks items blockIdx.x, + gridDim.x, ...; an item is
// (row tile, channel slice), slice fastest, and is C / kBK chunks long. The
// walk is one sequence of chunks: the next chunk (maybe the next item's
// first) is fetched while this one's products run. V is the elements a
// load: 16 bytes' worth where C and the pointers allow it, else 1.
template <typename T, int V, bool kInverse>
__global__ void __launch_bounds__(kGenThreads, kGenCtasPerSm)
gdn_general_kernel(const T* __restrict__ x, const T* __restrict__ beta,
                   const T* __restrict__ gamma, T* __restrict__ out, long long rows,
                   int C) {
  using R = typename RouteOf<T, V>::type;
  using A = typename R::Acc;
  extern __shared__ __align__(16) unsigned char gen_smem[];
  A* bufs = reinterpret_cast<A*>(gen_smem);

  const int slices = (C + R::kBN - 1) / R::kBN;
  const int chunks = (C + R::kBK - 1) / R::kBK;
  const long long items = (rows + kGenBM - 1) / kGenBM * slices;
  const int warp = threadIdx.x / 32;
  const int wr = (warp % kGenWarpsM) * R::kWarpRows;  // the warp's tile in the CTA's
  const int wc = (warp / kGenWarpsM) * R::kWarpCols;

  long long item = blockIdx.x;
  if (item >= items) return;
  int chunk = 0, buf = 0;
  typename R::Staged staged;
  staged.fetch(x, gamma, rows, C, item / slices * kGenBM,
               static_cast<int>(item % slices) * R::kBN, 0);
  R::stash(staged, bufs);
  __syncthreads();
  // The chunk after this one.
  long long next_item = item;
  int next_chunk = chunk + 1;
  if (next_chunk == chunks) next_chunk = 0, next_item += gridDim.x;
  bool has_next = next_item < items;
  if (has_next)
    staged.fetch(x, gamma, rows, C, next_item / slices * kGenBM,
                 static_cast<int>(next_item % slices) * R::kBN, next_chunk * R::kBK);

  typename R::Accum acc{};
  for (;;) {
    const int n0 = static_cast<int>(item % slices) * R::kBN;
    // A warp whose channels all lie past C has no products to take.
    const bool active = n0 + wc < C;
    A* cur = bufs + buf * R::kBuffer;
    if (active) R::template products<0, R::kSteps / 2>(acc, cur, wr, wc);
    // The next chunk into the other buffer, then the one after that into
    // the registers it frees: its loads have the rest of this chunk and
    // half of the next to land.
    long long after_item = next_item;
    int after_chunk = next_chunk + 1;
    if (after_chunk == chunks) after_chunk = 0, after_item += gridDim.x;
    const bool has_after = has_next && after_item < items;
    if (has_next) R::stash(staged, bufs + (buf ^ 1) * R::kBuffer);
    if (has_after)
      staged.fetch(x, gamma, rows, C, after_item / slices * kGenBM,
                   static_cast<int>(after_item % slices) * R::kBN, after_chunk * R::kBK);
    if (active) R::template products<R::kSteps / 2, R::kSteps>(acc, cur, wr, wc);
    __syncthreads();

    if (chunk == chunks - 1) {  // this buffer is free now: the epilogue's tile
      finish<R, V, kInverse>(acc, cur, x, beta, out, rows, C, item / slices * kGenBM, n0, wr,
                             wc, active);
      acc = typename R::Accum{};
    }
    if (!has_next) break;
    item = next_item, chunk = next_chunk, buf ^= 1;
    next_item = after_item, next_chunk = after_chunk, has_next = has_after;
  }
}

template <typename T, int V, bool kInverse>
cudaError_t launch_general_as(const T* x, const T* beta, const T* gamma, T* out,
                              long long rows, int channels, cudaStream_t stream) {
  using R = typename RouteOf<T, V>::type;
  auto kernel = gdn_general_kernel<T, V, kInverse>;
  // CTAs in one wave; computed once per instantiation (one device).
  static int max_ctas = 0;
  if (max_ctas == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGenThreads,
                                                        R::kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_ctas = sms * per_sm;
  }
  const long long slices = (channels + R::kBN - 1) / R::kBN;
  const long long items = (rows + kGenBM - 1) / kGenBM * slices;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int ctas = items < max_ctas ? static_cast<int>(items) : max_ctas;
  kernel<<<ctas, kGenThreads, R::kSmem, stream>>>(x, beta, gamma, out, rows, channels);
  return cudaGetLastError();
}

// The float32 route for a C that TMA can stream (C % 4 == 0: 16-byte row
// strides; x and y 16-byte aligned): K1's split-TF32 wgmma with the x tile
// streamed in 32-channel K blocks through a ring of TMA stages, so that any
// width fits in shared memory. A CTA keeps gamma's hi and lo parts for a
// slice of NS output channels (64, or 32 or 16 where a wider slice does
// not fit beside the ring), transposed and swizzled as K1's. Two consumer
// warpgroups each walk their own 64-row tiles, K block by K block: wait
// for the block's stage, square and split x into the A fragments in
// registers (and keep the x of the output channels for the epilogue), mark
// the stage read, issue the block's products and keep one block in flight
// while building the next, into the other of two fragment sets (with one
// set, the next block's build overwrote registers that the products in
// flight still read). A producer warpgroup, its registers given to the
// consumers (setmaxnreg), refills each stage with TMA as soon as it is
// read. Each k-step takes four TF32 products: 3xTF32's lo*hi, hi*lo and
// hi*hi, and lo*lo, which 3xTF32 drops: without it, a 320-filter model's
// quantized step on the card rounded a latent the other way from the
// CPU's and missed chip_smoke.py's 16c gate. The S = C / NS CTAs that
// share a tile are neighbours in the grid and walk it in step, so all but
// the first read x from L2. Rows past the end and channels past C arrive as
// zeros (TMA's fill; gamma's slice is zero there); y is stored where it
// exists.
constexpr int kWideWarpgroups = 2;                          // consumers
constexpr int kWideThreads = 128 * (kWideWarpgroups + 1);  // and a producer warpgroup
constexpr int kWideStages = 4;              // K blocks in flight a warpgroup
constexpr int kWideStage = kTileRows * kBlockK;  // floats a stage

__host__ __device__ constexpr int wide_smem_bytes(int ns, int kblocks) {
  return 1024 + 2 * kblocks * ns * kBlockK * 4 + kWideWarpgroups * kWideStages * kWideStage * 4 +
         2 * kWideWarpgroups * kWideStages * 8;
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// K block j of a warpgroup's walk (tile first + (j / KB) * stride, block
// j % KB) into its stage j % kWideStages.
__device__ __forceinline__ void issue_block(const CUtensorMap* map, float* stages,
                                            uint64_t* bars, long long j, int first, int stride,
                                            int tiles, int KB) {
  const long long tile = first + j / KB * stride;
  if (tile >= tiles) return;
  const int slot = static_cast<int>(j % kWideStages);
  mbar_expect_tx(&bars[slot], kWideStage * 4);
  tma_load_2d(stages + slot * kWideStage, map, &bars[slot], static_cast<int>(j % KB) * kBlockK,
              static_cast<int>(tile) * kTileRows);
}

template <int NS, bool kInverse>
__global__ void __launch_bounds__(kWideThreads, 1)
gdn_general_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const float* __restrict__ beta, const float* __restrict__ gamma,
                       float* __restrict__ out, int rows, int C) {
  const int KB = (C + kBlockK - 1) / kBlockK;  // K blocks a row
  const int S = (C + NS - 1) / NS;             // CTAs sharing each x tile

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* g_hi = reinterpret_cast<float*>(base);  // [KB][NS][32], swizzled
  float* g_lo = g_hi + KB * NS * kBlockK;
  float* ring = g_lo + KB * NS * kBlockK;  // [kWideWarpgroups][kWideStages][64][32], swizzled
  // A stage is full when TMA has written it, empty when the 128 threads of
  // its warpgroup have read it.
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWideWarpgroups * kWideStages * kWideStage);
  uint64_t* empty = full + kWideWarpgroups * kWideStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * (wtid / 32) + g;  // this thread's rows: r0 and r0 + 8
  const int n0 = (blockIdx.x % S) * NS;
  const int stride = (gridDim.x / S) * kWideWarpgroups;
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  const int first = (blockIdx.x / S) * kWideWarpgroups + wg;

  if (tid == 0) {
    for (int i = 0; i < kWideWarpgroups * kWideStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == kWideWarpgroups) {
    // The producer warpgroup gives its registers to the consumers; one of
    // its threads keeps kWideStages blocks in flight for each consumer
    // warpgroup, refilling a stage as soon as that warpgroup has read it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (wtid == 0) {
      long long next[kWideWarpgroups], total[kWideWarpgroups];
      for (int w = 0; w < kWideWarpgroups; ++w) {
        const int f = (blockIdx.x / S) * kWideWarpgroups + w;
        total[w] = f < tiles ? static_cast<long long>((tiles - f + stride - 1) / stride) * KB : 0;
        for (next[w] = 0; next[w] < kWideStages && next[w] < total[w]; ++next[w])
          issue_block(&x_map, ring + w * kWideStages * kWideStage, full + w * kWideStages,
                      next[w], f, stride, tiles, KB);
      }
      for (bool more = true; more;) {
        more = false;
        bool issued = false;
        for (int w = 0; w < kWideWarpgroups; ++w) {
          if (next[w] >= total[w]) continue;
          more = true;
          const int slot = static_cast<int>(next[w] % kWideStages);
          // The stage's previous block, next - kWideStages, was read.
          if (!mbar_test(&empty[w * kWideStages + slot],
                         static_cast<uint32_t>(next[w] / kWideStages - 1) & 1))
            continue;
          issue_block(&x_map, ring + w * kWideStages * kWideStage, full + w * kWideStages,
                      next[w], (blockIdx.x / S) * kWideWarpgroups + w, stride, tiles, KB);
          ++next[w];
          issued = true;
        }
        if (!issued) __nanosleep(32);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  float* stages = ring + wg * kWideStages * kWideStage;
  uint64_t* bars = full + wg * kWideStages;
  uint64_t* frees = empty + wg * kWideStages;

  // gamma's slice, transposed to [n][k] and split, while the first blocks
  // load (K1's layout and read pattern).
  for (int i = tid; i < NS * KB * kBlockK; i += 128 * kWideWarpgroups) {
    const int q = i / 32;
    const int n = (q % (NS / 8)) * 8 + (i & 7);
    const int k = (q / (NS / 8)) * 4 + ((i >> 3) & 3);
    const float v = (k < C && n0 + n < C) ? gamma[static_cast<long long>(k) * C + n0 + n] : 0.f;
    const uint32_t hi = tf32_rna(v);
    const int off = (k / kBlockK) * NS * kBlockK + n * kBlockK +
                    ((((k % kBlockK) >> 2) ^ (n & 7)) << 2) + (k & 3);
    g_hi[off] = __uint_as_float(hi);
    g_lo[off] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
  float2 b[NS / 8];
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    b[j] = n < C ? make_float2(beta[n], beta[n + 1]) : make_float2(1.f, 1.f);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kWideWarpgroups) : "memory");  // consumers only

  const uint32_t hi_addr = smem_addr(g_hi);
  const uint32_t lo_addr = smem_addr(g_lo);
  long long j = 0;  // this warpgroup's K blocks so far
  for (int tile = first; tile < tiles; tile += stride) {
    float big[NS / 2], small[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) big[i] = small[i] = 0.f;
    fence_regs(big);
    fence_regs(small);
    float2 xe[NS / 8][2];
    // Block kb: wait for its stage, build its A fragments in (ahi, alo),
    // refill the stage, issue its products and keep them in flight. The
    // blocks alternate between two fragment sets, so that a block's build
    // never writes registers that the products before it still read.
    auto block = [&](int kb, uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4]) {
      const int slot = static_cast<int>(j % kWideStages);
      mbar_wait(&bars[slot], static_cast<uint32_t>(j / kWideStages) & 1);
      const float* p0 = stages + slot * kWideStage + r0 * kBlockK + t;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // k = 8s + t and 8s + t + 4: 16-byte chunks 2s and 2s + 1 of the
        // row, swizzled by the row's phase (r0 % 8 == (r0 + 8) % 8 == g).
        const int c0 = ((2 * s) ^ g) << 2;
        const int c1 = ((2 * s + 1) ^ g) << 2;
        const float v[4] = {p0[c0], p0[8 * kBlockK + c0], p0[c1], p0[8 * kBlockK + c1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float sq = v[q] * v[q];
          ahi[s][q] = tf32_rna(sq);
          alo[s][q] = tf32_rna(sq - __uint_as_float(ahi[s][q]));
        }
      }
      // x of this thread's output channels, from the block that holds them.
#pragma unroll
      for (int jj = 0; jj < NS / 8; ++jj) {
        const int n = n0 + 8 * jj + 2 * t;
        if (n / kBlockK != kb) continue;
        const int c = n % kBlockK;
        const float* p = stages + slot * kWideStage + r0 * kBlockK +
                         ((((c >> 2) ^ g)) << 2) + (c & 3);
        xe[jj][0] = *reinterpret_cast<const float2*>(p);
        xe[jj][1] = *reinterpret_cast<const float2*>(p + 8 * kBlockK);
      }
      mbar_arrive(&frees[slot]);  // this thread is done with the stage
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t koff = kb * NS * kBlockK * 4 + s * 32;
        wgmma(small, alo[s], sw128_desc(lo_addr + koff));
        wgmma(small, alo[s], sw128_desc(hi_addr + koff));
        wgmma(small, ahi[s], sw128_desc(lo_addr + koff));
        wgmma(big, ahi[s], sw128_desc(hi_addr + koff));
      }
      wgmma_commit();
      wgmma_wait<1>();
      ++j;
    };
    uint32_t ahi0[4][4], alo0[4][4], ahi1[4][4], alo1[4][4];
    for (int kb = 0; kb < KB; kb += 2) {
      block(kb, ahi0, alo0);
      if (kb + 1 < KB) block(kb + 1, ahi1, alo1);
    }
    wgmma_wait<0>();
    fence_regs(big);
    fence_regs(small);

    // Accumulator fragment: [4j + 2h + e] is (row r0 + 8h, col 8j + 2t + e).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile * kTileRows + r0 + 8 * h;
      if (row >= rows) continue;
      float* o = out + static_cast<long long>(row) * C + n0 + 2 * t;
#pragma unroll
      for (int jj = 0; jj < NS / 8; ++jj) {
        if (n0 + 8 * jj + 2 * t >= C) continue;  // C and n even: n + 1 < C too
        const float nx = big[4 * jj + 2 * h] + small[4 * jj + 2 * h] + b[jj].x;
        const float ny = big[4 * jj + 2 * h + 1] + small[4 * jj + 2 * h + 1] + b[jj].y;
        float2 y;
        y.x = xe[jj][h].x * (kInverse ? nx * rsqrtf(nx) : rsqrtf(nx));
        y.y = xe[jj][h].y * (kInverse ? ny * rsqrtf(ny) : rsqrtf(ny));
        *reinterpret_cast<float2*>(o + 8 * jj) = y;
      }
    }
  }
}

// The widest slice that fits beside the ring, or 0 when none does.
inline int wide_slice(int channels) {
  const int kblocks = (channels + kBlockK - 1) / kBlockK;
  for (int ns = 64; ns >= 16; ns /= 2)
    if (wide_smem_bytes(ns, kblocks) <= 232448) return ns;
  return 0;
}

template <int NS, bool kInverse>
cudaError_t launch_wide(const float* x, const float* beta, const float* gamma, float* out,
                        long long rows, int channels, cudaStream_t stream) {
  const int smem = wide_smem_bytes(NS, (channels + kBlockK - 1) / kBlockK);
  const int S = (channels + NS - 1) / NS;
  if (rows > INT_MAX - kTileRows) return cudaErrorInvalidValue;
  const int tiles = static_cast<int>((rows + kTileRows - 1) / kTileRows);
  auto kernel = gdn_general_tma_kernel<NS, kInverse>;
  // The attribute covers the largest slice any C gives this NS; the SMs
  // hold one CTA each whatever C is (computed once per instantiation).
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int max_groups = sms / S > 0 ? sms / S : 1;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(channels),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(channels) * 4};
  const cuuint32_t box[2] = {kBlockK, kTileRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int need = (tiles + kWideWarpgroups - 1) / kWideWarpgroups;
  const int groups = need < max_groups ? need : max_groups;
  kernel<<<groups * S, kWideThreads, smem, stream>>>(map, beta, gamma, out, static_cast<int>(rows),
                                                 channels);
  return cudaGetLastError();
}

template <bool kInverse>
cudaError_t launch_wide_as(int ns, const float* x, const float* beta, const float* gamma,
                           float* out, long long rows, int channels, cudaStream_t stream) {
  switch (ns) {
    case 64: return launch_wide<64, kInverse>(x, beta, gamma, out, rows, channels, stream);
    case 32: return launch_wide<32, kInverse>(x, beta, gamma, out, rows, channels, stream);
    default: return launch_wide<16, kInverse>(x, beta, gamma, out, rows, channels, stream);
  }
}

// The form is picked here, before the one launch: float32 that TMA can
// stream goes to gdn_general_tma_kernel; everything else to
// gdn_general_kernel, with 16-byte loads and stores where every row of x and
// gamma starts 16-byte aligned, else one element at a time.
template <typename T>
cudaError_t launch_general(const void* x, const void* beta, const void* gamma,
                           void* out, long long rows, int channels, int inverse,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(beta);
  const T* gt = static_cast<const T*>(gamma);
  T* ot = static_cast<T*>(out);
  if constexpr (std::is_same_v<T, float>) {
    const int ns = wide_slice(channels);
    if (ns && channels % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0)
      return inverse ? launch_wide_as<true>(ns, xt, bt, gt, ot, rows, channels, stream)
                     : launch_wide_as<false>(ns, xt, bt, gt, ot, rows, channels, stream);
  }
  const bool aligned = channels % kVec == 0 &&
                       ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (aligned)
    return inverse ? launch_general_as<T, kVec, true>(xt, bt, gt, ot, rows, channels, stream)
                   : launch_general_as<T, kVec, false>(xt, bt, gt, ot, rows, channels, stream);
  return inverse ? launch_general_as<T, 1, true>(xt, bt, gt, ot, rows, channels, stream)
                 : launch_general_as<T, 1, false>(xt, bt, gt, ot, rows, channels, stream);
}

}  // namespace

extern "C" {

// Channels supported: multiples of 32 from 32 to 192. x, beta and gamma
// must be 16-byte aligned (TMA and the float2 loads).
int tpc_gdn_forward(const void* x, const void* beta, const void* gamma,
                    void* out, long long rows, int channels, int inverse,
                    void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(beta);
  const float* gf = static_cast<const float*>(gamma);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 32: return dispatch<32>(xf, bf, gf, of, rows, inverse, s);
    case 64: return dispatch<64>(xf, bf, gf, of, rows, inverse, s);
    case 96: return dispatch<96>(xf, bf, gf, of, rows, inverse, s);
    case 128: return dispatch<128>(xf, bf, gf, of, rows, inverse, s);
    case 160: return dispatch<160>(xf, bf, gf, of, rows, inverse, s);
    case 192: return dispatch<192>(xf, bf, gf, of, rows, inverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fused_gdn_general: any channels >= 1; dtype 0 float32, 1 float64, 2 float16,
// 3 bfloat16 (x, beta and gamma all of it), each contiguous, with no
// alignment beyond the type's own.
int tpc_gdn_general_forward(const void* x, const void* beta, const void* gamma,
                            void* out, long long rows, int channels, int inverse,
                            int dtype, void* stream) {
  if (channels < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_general<float>(x, beta, gamma, out, rows, channels, inverse, s);
    case 1: return launch_general<double>(x, beta, gamma, out, rows, channels, inverse, s);
    case 2: return launch_general<__half>(x, beta, gamma, out, rows, channels, inverse, s);
    case 3:
      return launch_general<__nv_bfloat16>(x, beta, gamma, out, rows, channels, inverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tpc_gdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
