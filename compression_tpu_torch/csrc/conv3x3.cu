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

#include "tf32_wgmma.cuh"

namespace {

constexpr int kTileN = 120;  // output channels of a tile: HiFiC's 960 in 8
constexpr int kHaloH = kTileH + 2, kHaloW = kTileW + 2;
constexpr int kAStageBytes = a_stage_bytes(kHaloH, kHaloW);  // 180 rows

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_fprop_3xtf32_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap hi_map,
                            const __grid_constant__ CUtensorMap lo_map,
                            float* __restrict__ out, const Shape s) {
  constexpr int SB = b_stages(kAStageBytes, kTileN);
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
        const Tile tl = tile_of<kTileN>(s, t);
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
    const Tile tl = tile_of<kTileN>(s, t);
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

}  // namespace

extern "C" {

// x (n, h, w, cin), w_hi and w_lo (cout, 3, 3, cin), out (n, h, w, cout): all
// float32, contiguous and 16-byte aligned; cin and cout multiples of 4.
int tpc_conv3x3_forward(const void* x, const void* w_hi, const void* w_lo, void* out, int n,
                        int h, int w, int cin, int cout, void* stream) {
  return launch<kTileN, kHaloH, kHaloW>(conv3x3_fprop_3xtf32_kernel, x, w_hi, w_lo, out, n, h,
                                        w, cin, cout, stream);
}

const char* tpc_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
