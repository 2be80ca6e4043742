// Fused ChannelNorm for NVIDIA Hopper (sm_90a): HiFiC's normalisation over
// the channels of each position, with the bias of the convolution before it
// and the ReLU or the residual add after it, in one pass.
//
// Replaces no TPU kernel: the JAX package's ChannelNorm
// (compression_tpu/models/hific/archs.py) is plain jnp, which XLA fuses on
// its own. The port ran it as separate torch ops: the convolution's bias
// add, two means, the centring twice, the square, the scale and the offset,
// then the ReLU or the residual add, about eight reads and six writes of the
// whole activation.
//
// Over the trailing axis of x, seen as (rows, C) row-major, all float32 (or all
// float64, on the general path below):
//     v   = x [+ bias]
//     out = [residual +] [relu]((v - mean(v)) * rsqrt(var(v) + eps) * gamma + beta)
// var is the population variance, as the twin fused_channel_norm_reference
// (layers/channel_norm_kernel.py) takes it. Each row's mean and rstd are
// written as well where the caller asks (the backward's saved statistics).
//
// Bound on an H100 SXM: an element costs a few flops against 8 bytes (x read,
// out written; 12 with the residual), far below the card's ridge of 20 flops
// a byte (67 TFLOP/s over 3.35 TB/s). Bytes bound it: a decoded batch of
// eight 768x512 images normalises 580 M floats in 24 calls, 5.1 GB read and
// written once with the nine residuals, 1.5 ms at 3.35 TB/s.
//
// Design:
//  * One read of x (and of the residual) and one write of out: a row stays
//    in registers between its sum, its centred sum of squares and its output.
//  * Every op rounds as the twin's torch ops round on the card, so that at
//    HiFiC's widths the output is the twin's bit for bit. The two sums take
//    ATen's order (Layout below) and the mean is the sum times torch.mean's
//    factor; the rest is (((v - mean) * rstd) * gamma) + beta with each op
//    rounded on its own (no contraction to FMA) and rsqrtf, as torch.rsqrt.
//    A norm that rounds otherwise moves HiFiC's latents by an ulp, which
//    flips the few that lie at a rounding tie and moves whole patches of the
//    decoded image by tens of levels.
//  * Row slots are 16-byte (float4) loads, neighbouring lanes on
//    neighbouring slots: from C = 128 a warp takes one row (32 lanes), below
//    it four rows (8 lanes a row). Every HiFiC width is a multiple of 4.
//  * A persistent grid: a warp walks rows at the grid's stride and keeps its
//    slots' gamma, beta and bias in registers across them.
//  * Sums go through shuffles only: no shared memory, no atomics. Every row
//    takes them in the same order whatever its place in the grid, so a
//    row's result is the same on every run and at every batch size.
//  * Any other width, rows not 16-byte aligned, or float64 (HiFiC's float64
//    checks) take channel_norm_any_kernel: one warp a row, one element a
//    lane a step, three passes over the row (the second and third read it
//    from L1). Its sums take their own order, so it agrees with the twin to
//    rounding only.
//  * ATen's order is read from torch 2.11 (ATEN_ORDER_TORCH in
//    layers/channel_norm_kernel.py, which warns under another release);
//    tests/test_torch_cuda.py's test_channel_norm_sums_rows_as_torch_mean
//    checks it on the card.
//
// C interface (loaded with ctypes): tpc_channel_norm_forward returns the
// cudaError_t of the launch (0 on success); the wrapper raises otherwise.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Template flags of both kernels.
constexpr int kBias = 1, kRelu = 2, kResidual = 4;

template <typename T>
struct Args {
  const T* x;
  const T* gamma;
  const T* beta;
  const T* bias;      // null: no bias
  const T* residual;  // null: no residual add
  T* out;
  T* mean;  // null: statistics not written
  T* rstd;
  long long rows;
  int channels;
  T factor;  // a mean's 1 / C, as torch rounds it: float(rows) / float(rows * C)
  T eps;
};

// Each op rounded on its own, in float32 or float64.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rsqrt_of(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_of(double a) { return rsqrt(a); }

// ATen's reduction of a contiguous row of C floats (Reduce.cuh's
// ReduceConfig, at 16 rows or more): 32 lanes a row; below 128 channels
// lane m sums elements m, m + 32, m + 64, m + 96 in that order; from 128 it
// loads float4 slots m, m + 32, ..., sums each component on its own in that
// order and then adds them as ((x + y) + z) + w; then a shuffle tree with
// offsets 16, 8, 4, 2, 1. A mean is that sum times the factor.
//
// The kernel's layout holds those lanes' elements: from 128 channels lane m
// of 32 holds slots m + 32 j; below, a row takes 8 lanes and lane q holds
// slots q + 8 j, ATen's lanes 4q .. 4q + 3 as its four components.
template <int C>
struct Layout {
  static constexpr int kSlots = C / 4;
  static constexpr bool kWide = C >= 128;
  static constexpr int kLanes = kWide ? 32 : 8;  // lanes a row
  static constexpr int kPer = (kSlots + kLanes - 1) / kLanes;
  static constexpr int kRows = 32 / kLanes;      // rows a warp takes at once
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 xor4(float4 a, int off) {
  return make_float4(__shfl_xor_sync(kFull, a.x, off), __shfl_xor_sync(kFull, a.y, off),
                     __shfl_xor_sync(kFull, a.z, off), __shfl_xor_sync(kFull, a.w, off));
}

// The row's sum of the kPer slots in t (absent slots hold zeros and are
// skipped), in ATen's order; every lane of the row gets it.
template <int C>
__device__ __forceinline__ float row_sum(const float4 (&t)[Layout<C>::kPer], int sub) {
  using L = Layout<C>;
  float4 a = zero4();
#pragma unroll
  for (int j = 0; j < L::kPer; ++j) {
    if ((j + 1) * L::kLanes <= L::kSlots || sub + j * L::kLanes < L::kSlots) a = add4(a, t[j]);
  }
  if constexpr (L::kWide) {
    float p = __fadd_rn(__fadd_rn(__fadd_rn(a.x, a.y), a.z), a.w);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) p = __fadd_rn(p, __shfl_xor_sync(kFull, p, off));
    return p;
  } else {
    // ATen's offsets 16, 8 and 4 are lanes q ^ 4, ^ 2 and ^ 1 here; 2 and 1
    // are the components z, w against x, y, then y against x.
#pragma unroll
    for (int off = 4; off > 0; off /= 2) a = add4(a, xor4(a, off));
    return __fadd_rn(__fadd_rn(a.x, a.z), __fadd_rn(a.y, a.w));
  }
}

__device__ __forceinline__ float4 sub4(float4 a, float b) {
  return make_float4(__fsub_rn(a.x, b), __fsub_rn(a.y, b), __fsub_rn(a.z, b), __fsub_rn(a.w, b));
}

__device__ __forceinline__ float4 square4(float4 a) {
  return make_float4(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y), __fmul_rn(a.z, a.z),
                     __fmul_rn(a.w, a.w));
}

template <int kLanes, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) v = add_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// (((v - mean) * rstd) * gamma) + beta, each op rounded on its own, then the
// ReLU (NaN passes, as torch.relu's) and the residual add.
template <int kFlags, typename T>
__device__ __forceinline__ T finish(T v, T mu, T rs, T g, T b, T r) {
  T o = add_rn(mul_rn(mul_rn(sub_rn(v, mu), rs), g), b);
  if (kFlags & kRelu) o = o <= T(0) ? T(0) : o;
  if (kFlags & kResidual) o = add_rn(r, o);
  return o;
}

template <int C, int kFlags>
__global__ void __launch_bounds__(kThreads) channel_norm_rows_kernel(Args<float> a) {
  using L = Layout<C>;
  constexpr int kPer = L::kPer, kLanes = L::kLanes, kSlots = L::kSlots;
  const int lane = threadIdx.x % 32;
  const int sub = lane % kLanes;
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* r4 = reinterpret_cast<const float4*>(a.residual);
  float4* o4 = reinterpret_cast<float4*>(a.out);

  // A slot exists where j's full round of lanes fits, or where this lane's does.
  auto has = [&](int j) { return (j + 1) * kLanes <= kSlots || sub + j * kLanes < kSlots; };

  float4 g[kPer], b[kPer], c[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = sub + j * kLanes;
    g[j] = has(j) ? __ldg(reinterpret_cast<const float4*>(a.gamma) + i) : zero4();
    b[j] = has(j) ? __ldg(reinterpret_cast<const float4*>(a.beta) + i) : zero4();
    c[j] = (kFlags & kBias) && has(j) ? __ldg(reinterpret_cast<const float4*>(a.bias) + i)
                                      : zero4();
  }

  const long long stride = static_cast<long long>(gridDim.x) * kWarps * L::kRows;
  long long first = (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * L::kRows;
  for (; first < a.rows; first += stride) {  // uniform across the warp
    const long long row = first + lane / kLanes;
    const bool live = row < a.rows;
    const size_t at = static_cast<size_t>(row) * kSlots;
    float4 v[kPer], r[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = live && has(j);
      const int i = sub + j * kLanes;
      v[j] = ok ? x4[at + i] : zero4();
      r[j] = (kFlags & kResidual) && ok ? r4[at + i] : zero4();
      if (kFlags & kBias) v[j] = add4(v[j], c[j]);
    }
    const float mu = __fmul_rn(row_sum<C>(v, sub), a.factor);
    float4 sq[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) sq[j] = square4(sub4(v[j], mu));
    const float var = __fmul_rn(row_sum<C>(sq, sub), a.factor);
    const float rs = rsqrtf(__fadd_rn(var, a.eps));
    if (a.mean != nullptr && live && sub == 0) {
      a.mean[row] = mu;
      a.rstd[row] = rs;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (live && has(j)) {
        float4 o;
        o.x = finish<kFlags>(v[j].x, mu, rs, g[j].x, b[j].x, r[j].x);
        o.y = finish<kFlags>(v[j].y, mu, rs, g[j].y, b[j].y, r[j].y);
        o.z = finish<kFlags>(v[j].z, mu, rs, g[j].z, b[j].z, r[j].z);
        o.w = finish<kFlags>(v[j].w, mu, rs, g[j].w, b[j].w, r[j].w);
        o4[at + sub + j * kLanes] = o;
      }
    }
  }
}

template <int kFlags, typename T>
__device__ __forceinline__ T load_v(const Args<T>& a, const T* xr, int i) {
  return (kFlags & kBias) ? add_rn(xr[i], __ldg(a.bias + i)) : xr[i];
}

template <typename T, int kFlags>
__global__ void __launch_bounds__(kThreads) channel_norm_any_kernel(Args<T> a) {
  const int lane = threadIdx.x % 32;
  const int c = a.channels;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
       row < a.rows; row += stride) {
    const size_t at = static_cast<size_t>(row) * c;
    const T* xr = a.x + at;
    T s = 0;
    for (int i = lane; i < c; i += 32) s = add_rn(s, load_v<kFlags>(a, xr, i));
    const T mu = mul_rn(group_sum<32>(s), a.factor);
    T q = 0;
    for (int i = lane; i < c; i += 32) {
      const T d = sub_rn(load_v<kFlags>(a, xr, i), mu);
      q = add_rn(q, mul_rn(d, d));
    }
    const T rs = rsqrt_of(add_rn(mul_rn(group_sum<32>(q), a.factor), a.eps));
    if (a.mean != nullptr && lane == 0) {
      a.mean[row] = mu;
      a.rstd[row] = rs;
    }
    for (int i = lane; i < c; i += 32) {
      const T r = (kFlags & kResidual) ? a.residual[at + i] : T(0);
      a.out[at + i] = finish<kFlags>(load_v<kFlags>(a, xr, i), mu, rs, __ldg(a.gamma + i),
                                     __ldg(a.beta + i), r);
    }
  }
}

// The SM count of the first card asked, read once. It sizes the grid only
// (a grid-stride loop covers any rows), and a launch inside CUDA graph
// capture then makes no other runtime call.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> count{0};
  if (count.load() == 0) {
    int device, n = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    count.store(n);
  }
  *sms = count.load();
  return cudaSuccess;
}

// C = 0: channel_norm_any_kernel<T>; else channel_norm_rows_kernel<C>
// (float32 only). A persistent grid: as many blocks as fit on the card at
// once, fewer where the rows do not need them.
template <typename T, int C, int kFlags>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  void (*kernel)(Args<T>);
  long long rows_a_warp = 1;
  if constexpr (C == 0) {
    kernel = channel_norm_any_kernel<T, kFlags>;
  } else {
    kernel = channel_norm_rows_kernel<C, kFlags>;
    rows_a_warp = Layout<C>::kRows;
  }
  static std::atomic<int> per_sm{0};  // one instantiation's occupancy
  cudaError_t err;
  if (per_sm.load() == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    per_sm.store(n);
  }
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const long long warps = (a.rows + rows_a_warp - 1) / rows_a_warp;
  const long long blocks =
      std::min((warps + kWarps - 1) / kWarps, static_cast<long long>(sms) * per_sm.load());
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t by_flags(const Args<T>& a, int flags, cudaStream_t stream) {
  switch (flags) {
    case 0: return launch<T, C, 0>(a, stream);
    case 1: return launch<T, C, 1>(a, stream);
    case 2: return launch<T, C, 2>(a, stream);
    case 3: return launch<T, C, 3>(a, stream);
    case 4: return launch<T, C, 4>(a, stream);
    case 5: return launch<T, C, 5>(a, stream);
    case 6: return launch<T, C, 6>(a, stream);
    default: return launch<T, C, 7>(a, stream);
  }
}

template <typename T>
Args<T> args_of(const void* x, const void* gamma, const void* beta, const void* bias,
                const void* residual, void* out, void* mean, void* rstd, long long rows,
                int channels, double factor, double eps) {
  return Args<T>{static_cast<const T*>(x), static_cast<const T*>(gamma),
                 static_cast<const T*>(beta), static_cast<const T*>(bias),
                 static_cast<const T*>(residual), static_cast<T*>(out),
                 static_cast<T*>(mean), static_cast<T*>(rstd), rows, channels,
                 static_cast<T>(factor), static_cast<T>(eps)};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x, residual and out: rows x channels, row-major; gamma, beta and bias:
// channels; all float32, or all float64 with f64 set; bias and residual may
// be null; mean and rstd (rows each) are both null or both given; factor is
// a mean's 1 / C as torch.mean rounds it, float(rows) / float(rows *
// channels) in the tensors' type; factor and eps are rounded to it here.
int tpc_channel_norm_forward(const void* x, const void* gamma, const void* beta,
                             const void* bias, const void* residual, void* out, void* mean,
                             void* rstd, long long rows, int channels, int relu, int f64,
                             double factor, double eps, void* stream) {
  if (rows < 0 || channels < 1 || (mean == nullptr) != (rstd == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int flags = (bias ? kBias : 0) | (relu ? kRelu : 0) | (residual ? kResidual : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    return by_flags<double, 0>(args_of<double>(x, gamma, beta, bias, residual, out, mean, rstd,
                                               rows, channels, factor, eps),
                               flags, s);
  }
  const Args<float> a = args_of<float>(x, gamma, beta, bias, residual, out, mean, rstd, rows,
                                       channels, factor, eps);
  const bool rows16 = aligned16(x) && aligned16(gamma) && aligned16(beta) && aligned16(out) &&
                      (!bias || aligned16(bias)) && (!residual || aligned16(residual));
  if (rows16) {
    switch (channels) {
      case 60: return by_flags<float, 60>(a, flags, s);
      case 120: return by_flags<float, 120>(a, flags, s);
      case 220: return by_flags<float, 220>(a, flags, s);
      case 240: return by_flags<float, 240>(a, flags, s);
      case 480: return by_flags<float, 480>(a, flags, s);
      case 960: return by_flags<float, 960>(a, flags, s);
      default: break;
    }
  }
  return by_flags<float, 0>(a, flags, s);
}

const char* tpc_channel_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
