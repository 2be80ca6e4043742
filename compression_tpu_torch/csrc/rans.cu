// K3 and K2: the K-lane interleaved rANS encoder and decoder for NVIDIA
// Hopper (sm_90a).
//
// Replace the device coder of compression_tpu/codec/rans.py, which is an
// XLA lax.scan, not Pallas: K3 is make_rans_encoder -> encode (:178, scan at
// :230), K2 is make_rans_decoder -> decode (:257, scan at :337). The format
// is specified by compression_tpu_torch/codec/rans_ref.py; the streams are
// bit-identical to the JAX package's and to the plain PyTorch twins in
// compression_tpu_torch/codec/rans.py.
//
// Layout: one CTA per image, one thread per lane (K <= 1024 lanes; the
// block is K rounded up to a warp, and threads past K hold no lane).
// Element j of an image belongs to lane k = j mod K at step t = j div K.
// Tables (read through the read-only cache): fc[r][m] = f << 16 | c,
// slot2sym[r][slot], cdf_offset[r], escape[r] = cdf_length[r] - 2.
//
// Bound on an H100 SXM: per element the coder moves a few bytes (values
// i32 and rows u8 one way, about a sixth of a stream word the other) and
// does some twenty integer operations, so by the roofline the whole batch
// is microseconds of work, bound by bytes. What holds a kernel of B CTAs
// back is the serial chain: T = ceil(N / K) dependent steps, each with a
// block barrier and, in the decoder, three dependent loads (slot2sym ->
// fc -> stream word). At the main path's batch (B = 8, K = 128) only 8 of
// 132 SMs work. The design keeps each step to one __syncthreads():
//  * the lanes' word positions are block-wide prefix counts of their
//    masks (warp __ballot_sync/__popc, per-warp totals in shared memory,
//    double-buffered by step parity so one barrier a step suffices);
//  * the decoder counts the main pop's renorm reads and the escape pops
//    in the same barrier, so all three of a step's word reads are issued
//    at once, and escape-free steps skip the escape pops;
//  * the encoder divides with native u32 '/' and '%': exact on this card,
//    so none of the TPU's float-reciprocal workaround (_divmod32).
// A larger K or several CTAs per image is the later redesign.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch (0 on success); the wrapper raises otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kL = 1u << 16;  // renorm bound
constexpr uint32_t kM16 = 0xFFFFu;
constexpr uint32_t kHi16 = 0xFFFF0000u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;      // K <= 1024

struct Tables {
  const int32_t* fc;          // [num_rows][stride]
  const int32_t* slot2sym;    // [num_rows][1 << precision]
  const int32_t* cdf_offset;  // [num_rows]
  const int32_t* escape;      // [num_rows]
  int num_rows;
  int stride;                 // max cdf length - 1
  int precision;
};

template <typename RowT>
__device__ __forceinline__ int clip_row(RowT raw, int num_rows) {
  // jnp.take(..., mode="clip") on the row tables.
  const int r = static_cast<int>(raw);
  return min(max(r, 0), num_rows - 1);
}

__device__ __forceinline__ uint32_t load_fc(const Tables& tb, int r, int32_t m) {
  const long long last = static_cast<long long>(tb.num_rows) * tb.stride - 1;
  long long i = static_cast<long long>(r) * tb.stride + m;
  i = min(max(i, 0LL), last);
  return static_cast<uint32_t>(__ldg(tb.fc + i));
}

// ---------------------------------------------------------------------------
// K3: encoder. Walks t = T-1 .. 0; at each step every lane pushes payload-hi
// and payload-lo (escapes only), then its main symbol. Emission order is
// step descending, slot (hi, lo, main), lane descending, then the state
// flush (lanes K-1 .. 0, lo then hi). Word i of that order is written to
// scratch[W-1-i] (W = 3N + 2K, the most an image can emit), so the stream
// in decode order ends up in scratch[W-total .. W-1]; the tail copies its
// first min(total, cap) words to out and zeroes the rest, as the JAX
// scatter does (which keeps words with total-1-i < cap).
template <typename RowT>
__global__ void rans_encode_kernel(const int32_t* __restrict__ values,
                                   const RowT* __restrict__ rows, Tables tb,
                                   long long n, int lanes, long long cap,
                                   uint16_t* __restrict__ scratch,
                                   uint16_t* __restrict__ out,
                                   int32_t* __restrict__ lengths,
                                   uint8_t* __restrict__ overflow) {
  __shared__ int cnt_esc[2][kMaxWarps];
  __shared__ int cnt_em[2][kMaxWarps];

  const int k = threadIdx.x;
  const int lane = k % kWarp;
  const int warp = k / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const long long b = blockIdx.x;
  const int32_t* v_img = values + b * n;
  const RowT* r_img = rows + b * n;
  const long long W = 3 * n + 2LL * lanes;
  uint16_t* scr = scratch + b * W;
  const int P = tb.precision;
  const long long T = (n + lanes - 1) / lanes;
  const unsigned above = kFull << 1 << lane;  // lanes after mine in the warp

  uint32_t x = kL;
  long long base = 0;  // words emitted so far (the same in every thread)

  // One step ahead: the next element's value and row.
  int32_t nv = 0;
  RowT nr = 0;
  {
    const long long j = (T - 1) * lanes + k;
    if (T > 0 && k < lanes && j < n) {
      nv = v_img[j];
      nr = r_img[j];
    }
  }
  for (long long t = T - 1; t >= 0; --t) {
    const long long j = t * lanes + k;
    const bool valid = k < lanes && j < n;
    const int32_t value = nv;
    const RowT raw_row = nr;
    if (t > 0 && k < lanes) {  // step t-1 is never ragged: j - lanes < n
      nv = v_img[j - lanes];
      nr = r_img[j - lanes];
    }

    // The element's fields (rans.py _element_fields + the fc gather).
    uint32_t f = 1, c = 0, e = 0;
    bool esc = false;
    if (valid) {
      const int r = clip_row(raw_row, tb.num_rows);
      const uint32_t off = static_cast<uint32_t>(__ldg(tb.cdf_offset + r));
      const int32_t E = __ldg(tb.escape + r);
      const int32_t s = static_cast<int32_t>(static_cast<uint32_t>(value) - off);
      esc = !(s >= 0 && s < E);
      const int32_t m = esc ? E : s;
      e = s >= E ? (static_cast<uint32_t>(s) - static_cast<uint32_t>(E)) * 2u
                 : (0u - static_cast<uint32_t>(s)) * 2u - 1u;
      const uint32_t fcv = load_fc(tb, r, m);
      f = fcv >> 16;
      c = fcv & kM16;
    }

    // Pushes: the bypass chunks always emit; the main push renormalises
    // first, emitting the low word iff x >= f << (32 - P), tested as a
    // shift of x so a full-mass row (f == 2^P) cannot wrap.
    const uint16_t v_hi = static_cast<uint16_t>(x & kM16);
    if (esc) x = (x & kHi16) | (e >> 16);
    const uint16_t v_lo = static_cast<uint16_t>(x & kM16);
    if (esc) x = (x & kHi16) | (e & kM16);
    const bool em = valid && (x >> (32 - P)) >= f;
    const uint16_t v_m = static_cast<uint16_t>(x & kM16);
    if (em) x >>= 16;
    if (valid) {
      // f == 0 cannot be coded (no table row gives a coded symbol zero
      // mass); the clamp only keeps the division defined.
      const uint32_t fs = f ? f : 1u;
      x = ((x / fs) << P) + x % fs + c;
    }

    // Block-wide ranks of the emitting lanes, lane descending.
    const unsigned bal_esc = __ballot_sync(kFull, esc);
    const unsigned bal_em = __ballot_sync(kFull, em);
    const int par = static_cast<int>(t & 1);
    if (lane == 0) {
      cnt_esc[par][warp] = __popc(bal_esc);
      cnt_em[par][warp] = __popc(bal_em);
    }
    __syncthreads();
    int n_esc = 0, n_em = 0, up_esc = 0, up_em = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int ce = cnt_esc[par][w];
      const int cm = cnt_em[par][w];
      n_esc += ce;
      n_em += cm;
      if (w > warp) {
        up_esc += ce;
        up_em += cm;
      }
    }
    if (esc) {
      const long long i = base + up_esc + __popc(bal_esc & above);
      scr[W - 1 - i] = v_hi;
      scr[W - 1 - (i + n_esc)] = v_lo;
    }
    if (em) {
      const long long i = base + 2LL * n_esc + up_em + __popc(bal_em & above);
      scr[W - 1 - i] = v_m;
    }
    base += 2LL * n_esc + n_em;
  }

  // Flush: lanes K-1 .. 0, low half then high half.
  if (k < lanes) {
    const long long i = base + 2LL * (lanes - 1 - k);
    scr[W - 1 - i] = static_cast<uint16_t>(x & kM16);
    scr[W - 2 - i] = static_cast<uint16_t>(x >> 16);
  }
  const long long total = base + 2LL * lanes;
  __syncthreads();  // scratch writes are visible to the whole block
  uint16_t* o = out + b * cap;
  const uint16_t* src = scr + (W - total);
  for (long long i = k; i < cap; i += blockDim.x) o[i] = i < total ? src[i] : 0;
  if (k == 0) {
    lengths[b] = static_cast<int32_t>(total);
    overflow[b] = total > cap;
  }
}

// ---------------------------------------------------------------------------
// K2: decoder. Lane k's state starts as word[2k] << 16 | word[2k+1]; then,
// for t = 0 .. T-1: the main pop, its renorm read, and (only if some lane
// of the image escaped) the two bypass pops, each reading one word in
// ascending lane order at index min(p + rank, cap - 1), as rans.py:283
// clips; a corrupt stream therefore gives the same ok flag as the JAX
// package. ok = every lane's final state is 2^16.
template <typename RowT>
__global__ void rans_decode_kernel(const uint16_t* __restrict__ stream,
                                   long long cap, const RowT* __restrict__ rows,
                                   Tables tb, long long n, int lanes,
                                   int32_t* __restrict__ values,
                                   uint8_t* __restrict__ ok) {
  __shared__ int cnt_need[2][kMaxWarps];
  __shared__ int cnt_esc[2][kMaxWarps];

  const int k = threadIdx.x;
  const int lane = k % kWarp;
  const int warp = k / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const long long b = blockIdx.x;
  const uint16_t* st = stream + b * cap;
  const RowT* r_img = rows + b * n;
  int32_t* out = values + b * n;
  const int P = tb.precision;
  const uint32_t pmask = (1u << P) - 1u;
  const long long T = (n + lanes - 1) / lanes;
  const unsigned below = (1u << lane) - 1u;  // lanes before mine in the warp
  const long long last = cap - 1;

  uint32_t x = 0;
  if (k < lanes) {
    x = (static_cast<uint32_t>(st[2 * k]) << 16) | st[2 * k + 1];
  }
  long long p = 2LL * lanes;

  for (long long t = 0; t < T; ++t) {
    const long long j = t * lanes + k;
    const bool valid = k < lanes && j < n;
    int r = 0;
    int32_t E = 0;
    uint32_t m = 0;
    uint32_t x1 = x;
    if (valid) {
      r = clip_row(r_img[j], tb.num_rows);
      E = __ldg(tb.escape + r);
      const uint32_t slot = x & pmask;
      m = static_cast<uint32_t>(
          __ldg(tb.slot2sym + (static_cast<long long>(r) << P) + slot));
      const uint32_t fcv = load_fc(tb, r, static_cast<int32_t>(m));
      x1 = (fcv >> 16) * (x >> P) + slot - (fcv & kM16);
    }
    const bool need = valid && x1 < kL;
    const bool esc = valid && static_cast<int32_t>(m) == E;

    const unsigned bal_need = __ballot_sync(kFull, need);
    const unsigned bal_esc = __ballot_sync(kFull, esc);
    const int par = static_cast<int>(t & 1);
    if (lane == 0) {
      cnt_need[par][warp] = __popc(bal_need);
      cnt_esc[par][warp] = __popc(bal_esc);
    }
    __syncthreads();
    int n_need = 0, n_esc = 0, lo_need = 0, lo_esc = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int cn = cnt_need[par][w];
      const int ce = cnt_esc[par][w];
      n_need += cn;
      n_esc += ce;
      if (w < warp) {
        lo_need += cn;
        lo_esc += ce;
      }
    }
    // All of the step's reads at once: the renorm word, then (escapes) the
    // payload-lo pop's word and the payload-hi pop's word.
    uint32_t w0 = 0, w1 = 0, w2 = 0;
    if (need) {
      w0 = st[min(p + lo_need + __popc(bal_need & below), last)];
    }
    const long long p1 = p + n_need;
    if (esc) {
      const long long rank = lo_esc + __popc(bal_esc & below);
      w1 = st[min(p1 + rank, last)];
      w2 = st[min(p1 + n_esc + rank, last)];
    }
    p = p1 + 2LL * n_esc;

    x = need ? (x1 << 16) | w0 : x1;
    uint32_t s = m;
    if (esc) {
      const uint32_t b_lo = x & kM16;
      x = (x & kHi16) | w1;
      const uint32_t b_hi = x & kM16;
      x = (x & kHi16) | w2;
      const uint32_t e = (b_hi << 16) | b_lo;
      // e even: s = E + e/2; e odd: s = -(e/2 + 1) = ~(e/2); int32 wrap.
      s = (e & 1u) == 0 ? static_cast<uint32_t>(E) + (e >> 1) : ~(e >> 1);
    }
    if (valid) {
      out[j] = static_cast<int32_t>(
          s + static_cast<uint32_t>(__ldg(tb.cdf_offset + r)));
    }
  }
  const int all_ok = __syncthreads_and(k >= lanes || x == kL);
  if (k == 0) ok[b] = static_cast<uint8_t>(all_ok != 0);
}

int threads_for(int lanes) { return (lanes + kWarp - 1) / kWarp * kWarp; }

bool bad_args(int num_rows, int stride, int precision, int batch, long long n,
              int lanes) {
  return num_rows < 1 || stride < 1 || precision < 1 || precision > 15 ||
         batch < 1 || n < 0 || lanes < 1 || lanes > kWarp * kMaxWarps;
}

}  // namespace

extern "C" {

// values i32 [batch][n], rows u8 or i32 [batch][n] (rows_u8 says which),
// scratch u16 [batch][3n + 2*lanes], out u16 [batch][cap], lengths i32
// [batch], overflow u8 [batch].
int tpc_rans_encode(const void* values, const void* rows, int rows_u8,
                    const void* fc, const void* cdf_offset, const void* escape,
                    int num_rows, int stride, int precision, int batch,
                    long long n, int lanes, long long cap, void* scratch,
                    void* out, void* lengths, void* overflow, void* stream) {
  if (bad_args(num_rows, stride, precision, batch, n, lanes) || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables tb{static_cast<const int32_t*>(fc), nullptr,
                  static_cast<const int32_t*>(cdf_offset),
                  static_cast<const int32_t*>(escape), num_rows, stride,
                  precision};
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(lanes);
  auto* v = static_cast<const int32_t*>(values);
  auto* scr = static_cast<uint16_t*>(scratch);
  auto* o = static_cast<uint16_t*>(out);
  auto* len = static_cast<int32_t*>(lengths);
  auto* ovf = static_cast<uint8_t*>(overflow);
  if (rows_u8) {
    rans_encode_kernel<uint8_t><<<batch, threads, 0, s>>>(
        v, static_cast<const uint8_t*>(rows), tb, n, lanes, cap, scr, o, len, ovf);
  } else {
    rans_encode_kernel<int32_t><<<batch, threads, 0, s>>>(
        v, static_cast<const int32_t*>(rows), tb, n, lanes, cap, scr, o, len, ovf);
  }
  return static_cast<int>(cudaGetLastError());
}

// stream u16 [batch][cap], rows u8 or i32 [batch][n], values i32
// [batch][n], ok u8 [batch]. cap >= 2 * lanes (the head).
int tpc_rans_decode(const void* stream_words, long long cap, const void* rows,
                    int rows_u8, const void* fc, const void* slot2sym,
                    const void* cdf_offset, const void* escape, int num_rows,
                    int stride, int precision, int batch, long long n,
                    int lanes, void* values, void* ok, void* stream) {
  if (bad_args(num_rows, stride, precision, batch, n, lanes) ||
      cap < 2LL * lanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables tb{static_cast<const int32_t*>(fc),
                  static_cast<const int32_t*>(slot2sym),
                  static_cast<const int32_t*>(cdf_offset),
                  static_cast<const int32_t*>(escape), num_rows, stride,
                  precision};
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(lanes);
  auto* words = static_cast<const uint16_t*>(stream_words);
  auto* v = static_cast<int32_t*>(values);
  auto* okp = static_cast<uint8_t*>(ok);
  if (rows_u8) {
    rans_decode_kernel<uint8_t><<<batch, threads, 0, s>>>(
        words, cap, static_cast<const uint8_t*>(rows), tb, n, lanes, v, okp);
  } else {
    rans_decode_kernel<int32_t><<<batch, threads, 0, s>>>(
        words, cap, static_cast<const int32_t*>(rows), tb, n, lanes, v, okp);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpc_rans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
