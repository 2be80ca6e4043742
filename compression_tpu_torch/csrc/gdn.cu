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
// C interface (loaded with ctypes): tpc_gdn_forward returns the
// cudaError_t of the launch (0 on success); the wrapper raises otherwise.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
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

const char* tpc_gdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
