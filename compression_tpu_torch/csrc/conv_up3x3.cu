// A 3x3, stride-2, zero-padded up-convolution over channels-last float32
// for NVIDIA Hopper (sm_90a): each output phase from its own taps, in 3xTF32
// on the tensor cores, for HiFiC's generator (its up-convolutions up0-up3).
//
// Replaces no TPU kernel: the JAX package leaves every convolution to XLA.
// The port ran these as signal_conv's phase decomposition, one cuDNN
// convolution with a 2x2 support and 4 * cout output channels (7 of its 16
// taps zeros) in float32 with TF32 off, then a depth-to-space copy.
//
// signal_conv(x, w, corr=False, strides_up=2, padding="same_zeros",
// extra_pad_end=True) is, with w the (cout, cin, 3, 3) kernel in convolution
// orientation and x read as zero past the high edges,
//     out[2i,     2j] = x[i, j] w[1, 1]
//     out[2i,     2j + 1] = x[i, j] w[1, 2] + x[i, j + 1] w[1, 0]
//     out[2i + 1, 2j] = x[i, j] w[2, 1] + x[i + 1, j] w[0, 1]
//     out[2i + 1, 2j + 1] = x[i, j] w[2, 2] + x[i, j + 1] w[2, 0]
//                         + x[i + 1, j] w[0, 2] + x[i + 1, j + 1] w[0, 0]
// each term a sum over c < cin of x[n, ., ., c] * w[o, c, ky, kx]. x is (N,
// H, W, cin) and out (N, 2H, 2W, cout), both contiguous; the weight comes
// split ahead of time into two (cout, 3, 3, cin) tensors, w_hi = tf32(w) and
// w_lo = tf32(w - w_hi), rounded to nearest (layers/conv3x3_kernel.py's
// split_tf32, of the kernel as the layer holds it: no flip). No bias: the
// ChannelNorm after the convolution adds it.
//
// Bound on an H100 SXM: 9 (phase, tap) products an input pixel, 2 * N * H *
// W * cout * 9 * cin operations. Each of HiFiC's four up-convolutions of a
// decoded batch of eight 768x512 images is 101.9 GFLOP: 1.52 ms on the
// CUDA cores in float32 (67 TFLOP/s), 0.618 ms in 3xTF32 (three TF32
// products at 495 TFLOP/s; see conv3x3.cu for why one is too few). The last
// (120 to 60 channels at 256x384) also reads 0.38 GB and writes 0.75 GB,
// 0.34 ms at 3.35 TB/s: the operations bound every one, up3 narrowly.
//
// Design:
//  * A CTA takes a tile of 128 input pixels, 8 rows by 16 columns of one
//    image, by kTileN output channels: 120 (up0-up2's 480, 240 and 120 in 4,
//    2 and 1), or 64 where cout is at most 64 (up3's 60, where a tile of 120
//    would leave half the tensor cores idle). It computes the tile's four
//    output phases one after the other, each from its own 1, 2, 2 or 4 taps:
//    9 (phase, tap) products, where the phase convolution multiplies 16, and
//    one accumulator live. Each phase writes its pixels straight into the
//    interleaved output: no depth-to-space copy.
//  * Otherwise as conv3x3.cu: two consumer warpgroups take 4 of the 8 rows
//    each (wgmma's M of 64) and a producer warpgroup, its registers given
//    to them, keeps TMA loads in flight. K is walked a 32-channel block at a
//    time, and for each block and phase TMA brings the halo, 9 rows by 17
//    columns of x (the tile and the row and column after it; past the image
//    and past cin, TMA's zero fill), into a stage of the A ring; each tap
//    reads its shifted window into registers and splits it into hi and lo
//    there (the RS form of wgmma) against its weight slice (hi and lo) in a
//    stage of the B ring. A phase's halo is loaded again for the next phase,
//    from L2.
//  * Each tap's 12 products (4 k-steps of 8, 3 products each) go into a
//    fresh partial sum, which the CUDA cores add to a float32 accumulator,
//    rounded to nearest: a sum kept in the tensor cores' accumulator, which
//    rounds toward zero, reads far from float64 (conv3x3.cu). A consumer
//    builds the next tap's fragments while a tap's products run and then
//    waits for them (wait_group 0: a partial sum read while products are in
//    flight makes ptxas serialize every wgmma); the other warpgroup's
//    products keep the tensor cores busy meanwhile.
//  * A persistent grid walks the tiles, output-channel tile fastest.
//  * Determinism: an output's sum takes the same order (channel block, tap,
//    k-step, then lo*hi, hi*lo, hi*hi) whatever the batch, the grid or the
//    tile, and tiles never cross images: no split-K, no atomics.
//
// C interface (loaded with ctypes): tpc_conv_up3x3_forward returns the
// cudaError_t of the launch (0 on success); the wrapper raises otherwise.

#include "tf32_wgmma.cuh"

namespace {

// The halo: the tile and the row and the column after it.
constexpr int kHaloH = kTileH + 1, kHaloW = kTileW + 1;
constexpr int kAStageBytes = a_stage_bytes(kHaloH, kHaloW);  // 153 rows

// The (phase, tap) products, in the order an output sums them. Phase p = 2a
// + b writes out[2i + a, 2j + b] from products first_of(p) to first_of(p +
// 1) - 1; product q reads x[i + dy_of(q), j + dx_of(q)] against the weight
// tap tap_of(q) = 3 ky + kx.
__host__ __device__ constexpr int first_of(int p) {
  return p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 3 : p == 3 ? 5 : 9;
}
__host__ __device__ constexpr int dy_of(int q) { return q == 4 || q == 7 || q == 8; }
__host__ __device__ constexpr int dx_of(int q) { return q == 2 || q == 6 || q == 8; }
__host__ __device__ constexpr int tap_of(int q) {
  // (1,1); (1,2) (1,0); (2,1) (0,1); (2,2) (2,0) (0,2) (0,0)
  return q == 0 ? 4 : q == 1 ? 5 : q == 2 ? 3 : q == 3 ? 7 : q == 4 ? 1
       : q == 5 ? 8 : q == 6 ? 6 : q == 7 ? 2 : 0;
}

template <int kTileN>
__global__ void __launch_bounds__(kThreads, 1)
conv_up3x3_fprop_3xtf32_kernel(const __grid_constant__ CUtensorMap x_map,
                               const __grid_constant__ CUtensorMap hi_map,
                               const __grid_constant__ CUtensorMap lo_map,
                               float* __restrict__ out, const Shape s) {
  constexpr int SB = b_stages(kAStageBytes, kTileN);
  constexpr int kAcc = kTileN / 2;  // accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = base;                                // [kAStages][153][32], swizzled
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
        for (int p = 0; p < 4; ++p) {
          for (int kb = 0; kb < s.kblocks; ++kb) {
            const int sa = static_cast<int>(ja % kAStages);
            if (ja >= kAStages) {
              mbar_wait(&a_empty[sa], static_cast<uint32_t>(ja / kAStages - 1) & 1);
            }
            mbar_expect_tx(&a_full[sa], kHaloH * kHaloW * 128);
            tma_load_4d(a_ring + sa * kAStageBytes, &x_map, &a_full[sa], kb * kBlockK, tl.w0,
                        tl.h0, tl.img);
            ++ja;
            for (int q = first_of(p); q < first_of(p + 1); ++q, ++jb) {
              const int sb = static_cast<int>(jb % SB);
              if (jb >= SB) mbar_wait(&b_empty[sb], static_cast<uint32_t>(jb / SB - 1) & 1);
              unsigned char* stage = b_ring + sb * b_stage_bytes(kTileN);
              mbar_expect_tx(&b_full[sb], b_stage_bytes(kTileN));
              tma_load_3d(stage, &hi_map, &b_full[sb], kb * kBlockK, tap_of(q), tl.n0);
              tma_load_3d(stage + kTileN * 128, &lo_map, &b_full[sb], kb * kBlockK, tap_of(q),
                          tl.n0);
            }
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

    // One output phase of the tile: its products over every channel block,
    // then its pixels written.
    auto phase = [&](auto pc) {
      constexpr int P = decltype(pc)::value;
      constexpr int q0 = first_of(P), taps = first_of(P + 1) - first_of(P);
      // part starts at zero: the first tap of a phase adds nothing before it.
      float acc[kAcc], part[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
      fence_regs(acc);
      fence_regs(part);
      uint32_t ahi[2][4][4], alo[2][4][4];
      int held = -1;  // B stage whose products are in flight

      // Product q of a channel block: build its fragments into set F while
      // the product before it runs, wait for that one, release its B stage
      // and add its partial sum to acc, then issue this one's 12 products
      // into part.
      auto tap_group = [&](auto qc, auto fset) {
        constexpr int q = decltype(qc)::value;
        constexpr int F = decltype(fset)::value;
        const int sb = static_cast<int>(jb % SB);
        mbar_wait(&b_full[sb], static_cast<uint32_t>(jb / SB) & 1);
        const int row = (prow + dy_of(q)) * kHaloW + g + dx_of(q);  // halo row of the first pixel
        const int swz = row & 7;                                     // row + 8 has the same
        const float* p0 = reinterpret_cast<const float*>(
                              a_ring + static_cast<int>(ja % kAStages) * kAStageBytes) +
                          row * kBlockK + t4;
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          // k = 8st + t4 and 8st + t4 + 4: 16-byte chunks 2st and 2st + 1 of
          // the row, swizzled by the row's phase.
          const int c0 = ((2 * st) ^ swz) << 2;
          const int c1 = ((2 * st + 1) ^ swz) << 2;
          const float v[4] = {p0[c0], p0[8 * kBlockK + c0], p0[c1], p0[8 * kBlockK + c1]};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ahi[F][st][r] = tf32_rna(v[r]);
            alo[F][st][r] = tf32_rna(v[r] - __uint_as_float(ahi[F][st][r]));
          }
        }
        if (q == q0 + taps - 1) mbar_arrive(&a_empty[ja % kAStages]);  // the halo is in registers
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

      // One channel block's products; the fragment sets alternate from one
      // product to the next, so the second block of a pair starts on set
      // `taps % 2` and every set is known here.
      auto block = [&](auto second) {
        constexpr int shift = decltype(second)::value * taps;
        mbar_wait(&a_full[ja % kAStages], static_cast<uint32_t>(ja / kAStages) & 1);
        unroll<0, taps>([&](auto i) {
          constexpr int k = decltype(i)::value;
          tap_group(std::integral_constant<int, q0 + k>{},
                    std::integral_constant<int, (shift + k) % 2>{});
        });
        ++ja;
      };
      for (int kb = 0; kb < s.kblocks; kb += 2) {
        block(std::integral_constant<int, 0>{});
        if (kb + 1 < s.kblocks) block(std::integral_constant<int, 1>{});
      }
      wgmma_wait<0>();
      fence_regs(part);
      mbar_arrive(&b_empty[held]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];

      // This thread's input pixels: row prow of the tile, columns g and g +
      // 8; each gives the output pixel (2i + a, 2j + b) of this phase.
      constexpr int a = P / 2, b = P % 2;
      const int ih = tl.h0 + prow;
      if (ih < s.h) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int iw = tl.w0 + g + 8 * h;
          if (iw >= s.w) continue;
          float* o = out +
                     ((static_cast<long long>(tl.img) * 2 * s.h + 2 * ih + a) * 2 * s.w +
                      2 * iw + b) * s.cout +
                     tl.n0 + 2 * t4;
#pragma unroll
          for (int j = 0; j < kTileN / 8; ++j) {
            if (tl.n0 + 8 * j + 2 * t4 >= s.cout) continue;  // cout even: n + 1 < cout too
            *reinterpret_cast<float2*>(o + 8 * j) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    };
    unroll<0, 4>(phase);
  }
}

}  // namespace

extern "C" {

// x (n, h, w, cin), w_hi and w_lo (cout, 3, 3, cin), out (n, 2h, 2w, cout):
// all float32, contiguous and 16-byte aligned; cin and cout multiples of 4.
int tpc_conv_up3x3_forward(const void* x, const void* w_hi, const void* w_lo, void* out, int n,
                           int h, int w, int cin, int cout, void* stream) {
  return cout <= 64 ? launch<64, kHaloH, kHaloW>(conv_up3x3_fprop_3xtf32_kernel<64>, x, w_hi,
                                                 w_lo, out, n, h, w, cin, cout, stream)
                    : launch<120, kHaloH, kHaloW>(conv_up3x3_fprop_3xtf32_kernel<120>, x, w_hi,
                                                  w_lo, out, n, h, w, cin, cout, stream);
}

const char* tpc_conv_up3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
