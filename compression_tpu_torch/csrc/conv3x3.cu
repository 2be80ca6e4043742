// A 3x3, stride-1, zero-padded ("same") correlation over channels-last
// float32 for NVIDIA Hopper (sm_90a): an implicit GEMM on the tensor cores
// in 3xTF32, for HiFiC's generator (its conv_in and the residual blocks'
// convolutions).
//
// Replaces no TPU kernel: the JAX package leaves every convolution to XLA.
// The port ran these through cuDNN in float32 with TF32 off, where cuDNN
// picks its legacy CUDA-core kernels at 960 channels.
//
//     out[n, h, w, o] = sum over dy, dx in {0, 1, 2} and c < cin of
//                       x[n, h + dy - 1, w + dx - 1, c] * weight[o, dy, dx, c]
// with x read as zero outside the image. x is (N, H, W, cin) and out (N, H,
// W, cout), both contiguous; the weight comes split ahead of time into two
// (cout, 3, 3, cin) tensors, w_hi = tf32(weight) and w_lo = tf32(weight -
// w_hi), each rounded to nearest (layers/conv3x3_kernel.py). No bias: the
// ChannelNorm after the convolution adds it.
//
// Bound on an H100 SXM: the work is the GEMM M = N*H*W, N = cout, K = 9*cin.
// At a residual block of HiFiC's decode of eight 768x512 images (M = 12,288,
// N = 960, K = 8,640) that is 203.8 GFLOP against about 0.1 GB read and
// written: the operations bound it. In float32 on the CUDA cores (67 TFLOP/s)
// no kernel takes under 3.042 ms. The tensor cores take TF32, which keeps 11
// bits of the mantissa, too few for the codec (one TF32 product moves HiFiC's
// decoded pixels by tens of levels). 3xTF32 keeps about 21: with a = a_hi +
// a_lo and b = b_hi + b_lo, the product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (a_lo*b_lo dropped). Three TF32 products at 495 TFLOP/s take 1.235 ms.
//
// Design:
//  * A CTA computes a tile of 128 output pixels, 8 rows by 16 columns of one
//    image, by 120 output channels (960 in 8 tiles; 768 tiles at the
//    residual shape, 5.8 waves on 132 SMs). Two consumer warpgroups take 4
//    of the 8 rows each (wgmma's M of 64); a producer warpgroup, its
//    registers given to the consumers (setmaxnreg), keeps the loads in
//    flight with TMA.
//  * K is walked channel block by channel block (32 channels, one 128-byte
//    swizzle row), and within a block tap by tap. For each channel block TMA
//    brings the tile's halo, 10 rows by 18 columns of x, into one stage of
//    the A ring (its borders, and the channels past cin, arrive as zeros:
//    TMA's fill), so each activation is read from L2 once per tile and not
//    once per tap. Each of the 9 taps reads its shifted 8 x 16 window of the
//    halo into registers, splits it into hi and lo there (the RS form of
//    wgmma) and multiplies it with that tap's weight slice, which TMA brings
//    into a stage of the B ring (hi and lo, 120 rows of 32 channels each).
//  * The tensor cores round their sums toward zero, which over the 810 taps
//    of a residual convolution left a sum kept in their accumulator some 17x
//    further from float64 than cuDNN's float32 (an H100, random inputs at
//    the residual shape). So each tap's 12 products (4 k-steps of 8, 3
//    products each) go into a fresh partial sum (its first wgmma does not
//    add), and once they are done the partial sum is added to a float32
//    accumulator on the CUDA cores, rounded to nearest: 4-5x nearer float64
//    than cuDNN there.
//  * A consumer builds the next tap's fragments, into the other of two
//    sets, while a tap's products run, then waits for them (wait_group 0:
//    a partial sum read while any product is in flight makes ptxas
//    serialize every wgmma), adds the partial sum, frees the tap's B stage
//    and issues the next tap. The other warpgroup's products keep the
//    tensor cores busy meanwhile.
//  * A persistent grid walks the tiles, output-channel tile fastest, so
//    that the CTAs in flight read the same weight slices at about the same
//    time (L2 hits) and each halo from L2 at most cout / 120 times.
//  * Determinism: an output's sum takes the same order (channel block, tap,
//    k-step, then lo*hi, hi*lo, hi*hi) whatever the batch, the grid or the
//    tile, and tiles never cross images, so an image's pixels are computed
//    at the same place of the same tile alone as in a batch: no split-K,
//    no atomics.
//
// C interface (loaded with ctypes): tpc_conv3x3_forward returns the
// cudaError_t of the launch (0 on success); the wrapper raises otherwise.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockK = 32;               // fp32 channels in one 128-byte swizzle row
constexpr int kTileH = 8, kTileW = 16;    // output pixels of a tile
constexpr int kTileN = 120;               // output channels of a tile: HiFiC's 960 in 8
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;
constexpr int kConsumers = 2;             // warpgroups of 4 tile rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
constexpr int kAStages = 2;
// A halo stage: 180 rows of 128 bytes, rounded up to the 1024 bytes a
// 128-byte swizzle repeats over, so that every stage starts at phase 0.
constexpr int kAStageBytes = (kHaloH * kHaloW * 128 + 1023) / 1024 * 1024;
constexpr int kSmemLimit = 232448;
constexpr int kBarrierBytes = 256;

__host__ __device__ constexpr int b_stage_bytes(int bn) { return 2 * bn * 128; }  // hi and lo
__host__ __device__ constexpr int b_stages(int bn) {
  return (kSmemLimit - 1024 - kBarrierBytes - kAStages * kAStageBytes) / b_stage_bytes(bn);
}
__host__ __device__ constexpr int smem_bytes(int bn) {
  return 1024 + kAStages * kAStageBytes + b_stages(bn) * b_stage_bytes(bn) + kBarrierBytes;
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

// d (64 x 120) {=, +=} A (64 x 8, tf32, registers) * B (8 x 120, tf32,
// shared memory, K-major); kAccumulate 0 writes d, 1 adds to it. A's
// fragment: a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4), g = lane / 4 + 16 * warp, t = lane % 4. d's: [4j + 2h + e] is (row
// g + 8h, column 8j + 2t + e).
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

struct Shape {
  int n, h, w, cin, cout;
  int tiles_h, tiles_w, tiles_n, kblocks;
  long long tiles;
};

// Tile t: output-channel tile fastest, then the columns, the rows and the
// image of the pixel tile.
struct Tile {
  int img, h0, w0, n0;
};
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

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_fprop_3xtf32_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap hi_map,
                            const __grid_constant__ CUtensorMap lo_map,
                            float* __restrict__ out, const Shape s) {
  constexpr int SB = b_stages(kTileN);
  constexpr int kAcc = kTileN / 2;  // accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = base;                                // [kAStages][180][32], swizzled
  unsigned char* b_ring = a_ring + kAStages * kAStageBytes;    // [SB][hi, lo][kTileN][32], swizzled
  uint64_t* a_full = reinterpret_cast<uint64_t*>(b_ring + SB * b_stage_bytes(kTileN));
  uint64_t* a_empty = a_full + kAStages;
  uint64_t* b_full = a_empty + kAStages;
  uint64_t* b_empty = b_full + SB;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 128 * kConsumers);
    }
    for (int i = 0; i < SB; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // The producer warpgroup gives its registers to the consumers; one of
    // its threads issues every load of this CTA's tiles, in the order the
    // consumers read them, each into a stage once they have released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid % 128 == 0) {
      long long ja = 0, jb = 0;  // A and B stages issued so far
      for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
        const Tile tl = tile_of(s, t);
        for (int kb = 0; kb < s.kblocks; ++kb) {
          const int sa = static_cast<int>(ja % kAStages);
          if (ja >= kAStages) mbar_wait(&a_empty[sa], static_cast<uint32_t>(ja / kAStages - 1) & 1);
          mbar_expect_tx(&a_full[sa], kHaloH * kHaloW * 128);
          tma_load_4d(a_ring + sa * kAStageBytes, &x_map, &a_full[sa], kb * kBlockK, tl.w0 - 1,
                      tl.h0 - 1, tl.img);
          ++ja;
          for (int tap = 0; tap < 9; ++tap, ++jb) {
            const int sb = static_cast<int>(jb % SB);
            if (jb >= SB) mbar_wait(&b_empty[sb], static_cast<uint32_t>(jb / SB - 1) & 1);
            unsigned char* stage = b_ring + sb * b_stage_bytes(kTileN);
            mbar_expect_tx(&b_full[sb], b_stage_bytes(kTileN));
            tma_load_3d(stage, &hi_map, &b_full[sb], kb * kBlockK, tap, tl.n0);
            tma_load_3d(stage + kTileN * 128, &lo_map, &b_full[sb], kb * kBlockK, tap, tl.n0);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int prow = 4 * wg + warp;  // this warp's pixel row in the tile
  const uint32_t b_base = smem_addr(b_ring);
  long long ja = 0, jb = 0;  // A and B stages consumed so far

  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const Tile tl = tile_of(s, t);
    // part starts at zero: the first tap of a tile adds nothing before it.
    float acc[kAcc], part[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
    fence_regs(acc);
    fence_regs(part);
    uint32_t ahi[2][4][4], alo[2][4][4];
    int held = -1;  // B stage whose products are in flight

    // One tap of a channel block: build its fragments into set F while the
    // tap before it runs, wait for that tap, release its B stage and add its
    // partial sum to acc, then issue this tap's 12 products into part.
    auto tap_group = [&](int tap, auto fset) {
      constexpr int F = decltype(fset)::value;
      const int sb = static_cast<int>(jb % SB);
      mbar_wait(&b_full[sb], static_cast<uint32_t>(jb / SB) & 1);
      const int dy = tap / 3, dx = tap % 3;
      const int row = (prow + dy) * kHaloW + g + dx;  // halo row of this thread's first pixel
      const int phase = row & 7;                      // row + 8 has the same
      const float* p0 = reinterpret_cast<const float*>(
                            a_ring + static_cast<int>(ja % kAStages) * kAStageBytes) +
                        row * kBlockK + t4;
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        // k = 8st + t4 and 8st + t4 + 4: 16-byte chunks 2st and 2st + 1 of
        // the row, swizzled by the row's phase.
        const int c0 = ((2 * st) ^ phase) << 2;
        const int c1 = ((2 * st + 1) ^ phase) << 2;
        const float v[4] = {p0[c0], p0[8 * kBlockK + c0], p0[c1], p0[8 * kBlockK + c1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ahi[F][st][q] = tf32_rna(v[q]);
          alo[F][st][q] = tf32_rna(v[q] - __uint_as_float(ahi[F][st][q]));
        }
      }
      if (tap == 8) mbar_arrive(&a_empty[ja % kAStages]);  // the halo is in registers
      wgmma_wait<0>();
      fence_regs(part);
      if (held >= 0) mbar_arrive(&b_empty[held]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
      const uint32_t hi_addr = b_base + sb * b_stage_bytes(kTileN);
      const uint32_t lo_addr = hi_addr + kTileN * 128;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        if (st == 0) {
          wgmma<0>(part, alo[F][st], sw128_desc(hi_addr + st * 32));
        } else {
          wgmma<1>(part, alo[F][st], sw128_desc(hi_addr + st * 32));
        }
        wgmma<1>(part, ahi[F][st], sw128_desc(lo_addr + st * 32));
        wgmma<1>(part, ahi[F][st], sw128_desc(hi_addr + st * 32));
      }
      wgmma_commit();
      held = sb;
      ++jb;
    };
    using Set0 = std::integral_constant<int, 0>;
    using Set1 = std::integral_constant<int, 1>;

    // Taps alternate between the two fragment sets; a channel block has 9,
    // so two blocks make a whole number of pairs and every set is known here.
    for (int kb = 0; kb < s.kblocks; kb += 2) {
      mbar_wait(&a_full[ja % kAStages], static_cast<uint32_t>(ja / kAStages) & 1);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (tap % 2 == 0) tap_group(tap, Set0{}); else tap_group(tap, Set1{});
      }
      ++ja;
      if (kb + 1 < s.kblocks) {
        mbar_wait(&a_full[ja % kAStages], static_cast<uint32_t>(ja / kAStages) & 1);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          if (tap % 2 == 0) tap_group(tap, Set1{}); else tap_group(tap, Set0{});
        }
        ++ja;
      }
    }
    wgmma_wait<0>();
    fence_regs(part);
    mbar_arrive(&b_empty[held]);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];

    // This thread's pixels: row prow of the tile, columns g and g + 8.
    const int ph = tl.h0 + prow;
    if (ph < s.h) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pw = tl.w0 + g + 8 * h;
        if (pw >= s.w) continue;
        float* o = out + ((static_cast<long long>(tl.img) * s.h + ph) * s.w + pw) * s.cout +
                   tl.n0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          if (tl.n0 + 8 * j + 2 * t4 >= s.cout) continue;  // cout even: n + 1 < cout too
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
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

cudaError_t launch(const float* x, const float* w_hi, const float* w_lo, float* out, int n,
                   int h, int w, int cin, int cout, cudaStream_t stream) {
  constexpr int smem = smem_bytes(kTileN);
  static_assert(smem <= kSmemLimit, "rings exceed shared memory");
  static_assert(b_stages(kTileN) >= 2, "the B ring needs two stages");
  auto kernel = conv3x3_fprop_3xtf32_kernel;
  static int sms = 0;  // computed once (one device)
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
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
    return cudaErrorInvalidValue;
  const long long grid = s.tiles < sms ? s.tiles : sms;
  kernel<<<static_cast<int>(grid), kThreads, smem, stream>>>(x_map, hi_map, lo_map, out, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, h, w, cin), w_hi and w_lo (cout, 3, 3, cin), out (n, h, w, cout): all
// float32, contiguous and 16-byte aligned; cin and cout multiples of 4.
int tpc_conv3x3_forward(const void* x, const void* w_hi, const void* w_lo, void* out, int n,
                        int h, int w, int cin, int cout, void* stream) {
  if (n < 0 || h < 1 || w < 1 || cin < 4 || cout < 4 || cin % 4 || cout % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(w_hi);
  const float* lf = static_cast<const float*>(w_lo);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(xf, hf, lf, of, n, h, w, cin, cout, s);
}

const char* tpc_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
