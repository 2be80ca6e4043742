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
// the widths and types K1 does not take, in plain CUDA C++.
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
// multiply-adds. This kernel does them on the CUDA cores, but the card could
// do them on its tensor cores within the same tolerances: float32 as 3xTF32
// (K1 above keeps 2e-5 so), double on the FP64 tensor cores (DMMA), bf16 and
// fp16 with a float accumulator. At C = 256 on 786,432 rows (the first GDN of
// a batch of eight 768x512 images) the 103 GFLOP take 0.62 ms as 3xTF32 at
// 495 TFLOP/s against 0.48 ms for the 1.6 GB of float32 bytes, and 1.54 ms in
// double at 67 TFLOP/s against 0.96 ms of bytes; bf16 is bound by its bytes.
// A tensor-core route for these widths is still to be written.
//
// Design: a CTA takes 128 rows and 64 output channels; each of its 256
// threads keeps an 8-row by 4-channel block of the norm in registers. It
// walks the input channels in chunks of 16, staging x*x ([k][row]; the row
// stride padded to 132 against bank conflicts, 16-byte aligned for vector
// reads) and gamma's [16][64] slice in shared memory, the next chunk's
// values loaded into registers while this one's products run. A step of k
// is three 16-byte shared loads (six for double: 8 rows of x*x, 4 channels
// of gamma) for 32 multiply-adds. The epilogue adds beta and multiplies by
// x in registers. Every row takes the same products in the same order (k =
// 0..C-1), so a row's result does not depend on its tile or batch. It
// launches on the caller's stream and never synchronizes: it can be
// captured in a CUDA graph.
constexpr int kGenRows = 128;
constexpr int kGenCols = 64;
constexpr int kGenK = 16;  // input channels a chunk (at 32, double's tiles pass 48 KB)
constexpr int kGenThreads = 256;
constexpr int kGenTR = 8;                 // rows a thread
constexpr int kGenTC = 4;                 // output channels a thread
constexpr int kGenXStride = kGenRows + 4;  // x*x row stride in shared memory

template <typename T> struct Accum { using type = float; };
template <> struct Accum<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// IGDN in float as norm * rsqrtf(norm), as K1 does, not the IEEE sqrtf (a
// longer sequence with a special-case branch).
__device__ __forceinline__ float norm_scale(float norm, bool inverse) {
  return inverse ? norm * rsqrtf(norm) : rsqrtf(norm);
}
__device__ __forceinline__ double norm_scale(double norm, bool inverse) {
  return inverse ? sqrt(norm) : rsqrt(norm);
}

// Four consecutive values from 16-byte aligned shared memory into v[at..].
template <int N>
__device__ __forceinline__ void load4(const float* p, float (&v)[N], int at) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[at] = a.x, v[at + 1] = a.y, v[at + 2] = a.z, v[at + 3] = a.w;
}
template <int N>
__device__ __forceinline__ void load4(const double* p, double (&v)[N], int at) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[at] = a.x, v[at + 1] = a.y, v[at + 2] = b.x, v[at + 3] = b.y;
}

// Two CTAs an SM where the accumulators are float (at most 128 registers a
// thread); double's need more.
template <typename T, bool kInverse>
__global__ void __launch_bounds__(kGenThreads, sizeof(typename Accum<T>::type) == 4 ? 2 : 1)
gdn_general_kernel(const T* __restrict__ x, const T* __restrict__ beta,
                   const T* __restrict__ gamma, T* __restrict__ out,
                   long long rows, int C) {
  using A = typename Accum<T>::type;
  __shared__ __align__(16) A xs[kGenK][kGenXStride];  // x*x, [k][row]
  __shared__ __align__(16) A gs[kGenK][kGenCols];     // gamma[k0 + k][n0 + n]

  const int tid = threadIdx.x;
  const int c0 = (tid % (kGenCols / kGenTC)) * kGenTC;  // this thread's channels
  const int r0 = (tid / (kGenCols / kGenTC)) * kGenTR;  // and rows, in the tile
  const long long row0 = static_cast<long long>(blockIdx.x) * kGenRows;
  const int n0 = blockIdx.y * kGenCols;

  A acc[kGenTR][kGenTC];
#pragma unroll
  for (int i = 0; i < kGenTR; ++i)
#pragma unroll
    for (int j = 0; j < kGenTC; ++j) acc[i][j] = A(0);

  // Each thread stages 8 values of x*x and 4 of gamma a chunk; the next
  // chunk's are loaded into registers while this one's products run. Half a
  // warp reads 16 neighbouring channels of a row, a warp 32 of gamma's.
  constexpr int kXPer = kGenRows * kGenK / kGenThreads;  // 8
  constexpr int kGPer = kGenK * kGenCols / kGenThreads;  // 4
  A xr[kXPer], gr[kGPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int i = tid + q * kGenThreads;
      const long long row = row0 + i / kGenK;
      const int k = k0 + i % kGenK;
      xr[q] = (row < rows && k < C) ? to_acc(x[row * C + k]) : A(0);
    }
#pragma unroll
    for (int q = 0; q < kGPer; ++q) {
      const int i = tid + q * kGenThreads;
      const int k = k0 + i / kGenCols, n = n0 + i % kGenCols;
      gr[q] = (k < C && n < C) ? to_acc(gamma[static_cast<long long>(k) * C + n]) : A(0);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < C; k0 += kGenK) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int i = tid + q * kGenThreads;
      xs[i % kGenK][i / kGenK] = xr[q] * xr[q];
    }
#pragma unroll
    for (int q = 0; q < kGPer; ++q) {
      const int i = tid + q * kGenThreads;
      gs[i / kGenCols][i % kGenCols] = gr[q];
    }
    __syncthreads();
    if (k0 + kGenK < C) fetch(k0 + kGenK);
#pragma unroll 4
    for (int k = 0; k < kGenK; ++k) {
      A a[kGenTR], g[kGenTC];
      load4(&xs[k][r0], a, 0);
      load4(&xs[k][r0 + 4], a, 4);
      load4(&gs[k][c0], g, 0);
#pragma unroll
      for (int i = 0; i < kGenTR; ++i)
#pragma unroll
        for (int j = 0; j < kGenTC; ++j) acc[i][j] += a[i] * g[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kGenTC; ++j) {
    const int n = n0 + c0 + j;
    if (n >= C) break;
    const A b = to_acc(beta[n]);
#pragma unroll
    for (int i = 0; i < kGenTR; ++i) {
      const long long row = row0 + r0 + i;
      if (row >= rows) break;
      const A xv = to_acc(x[row * C + n]);
      store(out + row * C + n, xv * norm_scale(acc[i][j] + b, kInverse));
    }
  }
}

template <typename T>
cudaError_t launch_general(const void* x, const void* beta, const void* gamma,
                           void* out, long long rows, int channels, int inverse,
                           cudaStream_t stream) {
  const long long row_tiles = (rows + kGenRows - 1) / kGenRows;
  if (row_tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((channels + kGenCols - 1) / kGenCols));
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(beta);
  const T* gt = static_cast<const T*>(gamma);
  T* ot = static_cast<T*>(out);
  if (inverse)
    gdn_general_kernel<T, true><<<grid, kGenThreads, 0, stream>>>(xt, bt, gt, ot, rows, channels);
  else
    gdn_general_kernel<T, false><<<grid, kGenThreads, 0, stream>>>(xt, bt, gt, ot, rows, channels);
  return cudaGetLastError();
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
// 3 bfloat16 (x, beta and gamma all of it), each contiguous.
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
