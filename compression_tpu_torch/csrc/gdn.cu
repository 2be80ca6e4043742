// K1: fused GDN / IGDN for NVIDIA Hopper (sm_90a), fp32 on the CUDA cores.
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
// does C*C multiply-adds. At the main path's C = 192 that is 1536 bytes
// against 73,728 flops a row, 48 flops a byte; the card's fp32 CUDA-core
// rate (67 TFLOP/s) over its HBM rate (3.35 TB/s) is 20 flops a byte, so
// the kernel is bound by fp32 operations, not by memory. (A batch of eight
// 768x512 images gives 1,032,192 GDN rows per direction: 76.1 GFLOP and
// 1.59 GB, 1.14 ms of fp32 work against 0.47 ms of traffic.) TF32 tensor
// cores would lift the ceiling, but keep ~3 decimal digits where the
// reference tolerance is 2e-5; a 3xTF32 split on wgmma is later work.
//
// Design, simple and right first:
//  * a persistent grid (at most one wave of CTAs), so each CTA loads gamma
//    (C*C*4 = 147,456 bytes at C = 192) into dynamic shared memory once and
//    then walks row tiles;
//  * a tile is 64 rows: its squares go to shared memory (float4 loads,
//    ragged last tile zero-filled);
//  * 256 threads = 8 row groups x 32 lanes; a thread owns 8 rows x C/32
//    columns of the output in registers. Per 4 input channels it reads 8
//    float4 squares (same address across the warp: a broadcast) and 4*C/32
//    gamma words (consecutive across the warp: no bank conflict), and does
//    32*C/32 fp32 FMAs; the sum runs over j in ascending order;
//  * the epilogue adds beta, applies rsqrtf/sqrtf and the multiply by x in
//    registers, masked on the ragged last tile.
//
// C interface (loaded with ctypes): tpc_gdn_forward returns the
// cudaError_t of the launch (0 on success); the wrapper raises otherwise.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowGroups = 8;
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kRowGroups * kRowsPerThread;  // 64
constexpr int kThreads = kWarp * kRowGroups;            // 256

template <int CPT, bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ beta,
           const float* __restrict__ gamma, float* __restrict__ out,
           long long rows) {
  constexpr int C = CPT * kWarp;
  constexpr int C4 = C / 4;
  extern __shared__ float4 smem4[];
  float* gamma_s = reinterpret_cast<float*>(smem4);  // [C][C]
  float4* sq4 = smem4 + C * C4;                      // [kTileRows][C4]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kWarp + tx;

  const float4* gamma4 = reinterpret_cast<const float4*>(gamma);
  for (int k = tid; k < C * C4; k += kThreads) smem4[k] = gamma4[k];
  float b[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) b[c] = beta[tx + c * kWarp];

  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    // gamma is in place; the previous tile's readers of sq4 are done.
    __syncthreads();
    for (int k = tid; k < kTileRows * C4; k += kThreads) {
      const int r = k / C4;
      const long long row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows) v = x4[row * C4 + (k - r * C4)];
      v.x *= v.x;
      v.y *= v.y;
      v.z *= v.z;
      v.w *= v.w;
      sq4[k] = v;
    }
    __syncthreads();

    float acc[kRowsPerThread][CPT];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

#pragma unroll 2
    for (int j4 = 0; j4 < C4; ++j4) {
      float4 s[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        s[r] = sq4[(ty + r * kRowGroups) * C4 + j4];
      const float* g_row = gamma_s + (4 * j4) * C + tx;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float g[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) g[c] = g_row[jj * C + c * kWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float sv = jj == 0 ? s[r].x : jj == 1 ? s[r].y
                         : jj == 2 ? s[r].z : s[r].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(sv, g[c], acc[r][c]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const long long row = row0 + ty + r * kRowGroups;
      if (row >= rows) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const long long idx = row * C + tx + c * kWarp;
        const float norm = acc[r][c] + b[c];
        const float xv = x[idx];
        out[idx] = kInverse ? xv * sqrtf(norm) : xv * rsqrtf(norm);
      }
    }
  }
}

template <int CPT, bool kInverse>
cudaError_t launch(const float* x, const float* beta, const float* gamma,
                   float* out, long long rows, cudaStream_t stream) {
  constexpr int C = CPT * kWarp;
  constexpr int smem = static_cast<int>(sizeof(float)) * (C * C + kTileRows * C);
  // One wave of CTAs; computed once per instantiation (one device).
  static int max_grid = 0;
  auto kernel = gdn_kernel<CPT, kInverse>;
  if (max_grid == 0) {
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
    max_grid = sms * per_sm;
  }
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  if (tiles == 0) return cudaSuccess;
  const unsigned grid =
      static_cast<unsigned>(tiles < max_grid ? tiles : max_grid);
  kernel<<<grid, dim3(kWarp, kRowGroups), smem, stream>>>(x, beta, gamma, out,
                                                          rows);
  return cudaGetLastError();
}

template <int CPT>
cudaError_t dispatch(const float* x, const float* beta, const float* gamma,
                     float* out, long long rows, int inverse,
                     cudaStream_t stream) {
  return inverse ? launch<CPT, true>(x, beta, gamma, out, rows, stream)
                 : launch<CPT, false>(x, beta, gamma, out, rows, stream);
}

}  // namespace

extern "C" {

// Channels supported: multiples of 32 from 32 to 192 (gamma and a 64-row
// tile must fit the 227 KB of shared memory a block may use).
int tpc_gdn_forward(const void* x, const void* beta, const void* gamma,
                    void* out, long long rows, int channels, int inverse,
                    void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(beta);
  const float* gf = static_cast<const float*>(gamma);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 32: return dispatch<1>(xf, bf, gf, of, rows, inverse, s);
    case 64: return dispatch<2>(xf, bf, gf, of, rows, inverse, s);
    case 96: return dispatch<3>(xf, bf, gf, of, rows, inverse, s);
    case 128: return dispatch<4>(xf, bf, gf, of, rows, inverse, s);
    case 160: return dispatch<5>(xf, bf, gf, of, rows, inverse, s);
    case 192: return dispatch<6>(xf, bf, gf, of, rows, inverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tpc_gdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
