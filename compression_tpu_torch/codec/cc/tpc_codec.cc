// C API for the TPU-compression host codec.
//
// Native equivalents of the reference's C++ custom ops (reference:
// tensorflow_compression/cc/kernels/range_coder_kernels.cc,
// range_coding_helper_kernels.cc, run_length_kernels.cc) re-designed as a
// dependency-free shared library driven from JAX via ctypes (either directly
// on host arrays or through jax.pure_callback). All entry points are batched
// and multi-threaded across batch elements: the per-symbol coding loop is
// inherently serial *within* a stream, so throughput comes from coding many
// streams (images / latent slices) concurrently while the TPU computes the
// next batch's transforms.
//
// === Bitstream format (normative) ===
//
// A stream codes n integer values against quantized CDF rows:
//   * Row i has `cdf_lengths[i]` int32 entries: cdf[0] = 0 <= ... <=
//     cdf[len-1] = 2^precision; symbol s in [0, len-2) spans
//     [cdf[s], cdf[s+1]). The LAST symbol (index len-2) is the ESCAPE
//     symbol.
//   * Value v with row i maps to symbol s = v - cdf_offsets[i]. In-range
//     symbols are range-coded directly. Out-of-range symbols code the
//     escape symbol followed by the Elias-gamma code of the zigzagged
//     excess e + 1, one raw (precision-1) range-coded bit at a time:
//       s >= len-2  ->  e = 2*(s - (len-2))
//       s < 0       ->  e = 2*(-s) - 1
//   * The range coder itself is defined in range_coder.h.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "range_coder.h"

namespace tpc {
namespace {

constexpr int kOk = 0;
constexpr int kCapacityError = 1;
constexpr int kBadArgs = 2;
constexpr int kCorrupt = 3;

// --- Elias gamma over the range coder (bit granularity) -------------------

inline void EncodeGamma(RangeEncoder* enc, uint64_t value) {
  // value >= 1. N = floor(log2(value)) zero bits, then value's N+1 bits.
  int n = 63 - __builtin_clzll(value);
  for (int i = 0; i < n; ++i) enc->EncodeBit(0);
  for (int i = n; i >= 0; --i) enc->EncodeBit((value >> i) & 1);
}

inline uint64_t DecodeGamma(RangeDecoder* dec) {
  int n = 0;
  while (dec->DecodeBit() == 0) {
    if (++n > 62) return 0;  // corrupt stream guard
  }
  uint64_t value = 1;
  for (int i = 0; i < n; ++i) value = (value << 1) | dec->DecodeBit();
  return value;
}

// --- Single-stream encode/decode ------------------------------------------

struct CdfTable {
  const int32_t* cdfs;
  const int32_t* lengths;
  const int32_t* offsets;
  int32_t num_cdfs;
  int32_t max_len;
  int32_t precision;
};

int EncodeStream(const int32_t* values, const int32_t* indexes, int64_t n,
                 const CdfTable& t, std::vector<uint8_t>* out) {
  RangeEncoder enc(out);
  for (int64_t k = 0; k < n; ++k) {
    const int32_t idx = indexes[k];
    if (idx < 0 || idx >= t.num_cdfs) return kBadArgs;
    const int32_t* row = t.cdfs + static_cast<int64_t>(idx) * t.max_len;
    const int32_t len = t.lengths[idx];
    if (len < 2 || len > t.max_len) return kBadArgs;
    const int32_t num_symbols = len - 1;   // includes the escape symbol
    const int32_t escape = num_symbols - 1;
    const int64_t s =
        static_cast<int64_t>(values[k]) - static_cast<int64_t>(t.offsets[idx]);
    if (s >= 0 && s < escape) {
      enc.Encode(row[s], row[s + 1] - row[s], t.precision);
    } else {
      enc.Encode(row[escape], row[escape + 1] - row[escape], t.precision);
      const uint64_t e = s >= escape
                             ? 2 * static_cast<uint64_t>(s - escape)
                             : 2 * static_cast<uint64_t>(-s) - 1;
      EncodeGamma(&enc, e + 1);
    }
  }
  enc.Finalize();
  return kOk;
}

int DecodeStream(const uint8_t* data, int64_t size, const int32_t* indexes,
                 int64_t n, const CdfTable& t, int32_t* values_out) {
  RangeDecoder dec(data, static_cast<size_t>(size));
  for (int64_t k = 0; k < n; ++k) {
    const int32_t idx = indexes[k];
    if (idx < 0 || idx >= t.num_cdfs) return kBadArgs;
    const int32_t* row = t.cdfs + static_cast<int64_t>(idx) * t.max_len;
    const int32_t len = t.lengths[idx];
    if (len < 2 || len > t.max_len) return kBadArgs;
    const int32_t num_symbols = len - 1;
    const int32_t escape = num_symbols - 1;
    const uint32_t f = dec.DecodeFreq(t.precision);
    // Binary search: find s with row[s] <= f < row[s+1].
    const int32_t* pos = std::upper_bound(row, row + len, static_cast<int32_t>(f));
    int64_t s = (pos - row) - 1;
    if (s < 0 || s >= num_symbols) return kCorrupt;
    dec.Update(row[s], row[s + 1] - row[s]);
    if (s == escape) {
      const uint64_t g = DecodeGamma(&dec);
      if (g == 0) return kCorrupt;
      const uint64_t e = g - 1;
      s = (e % 2 == 0) ? escape + static_cast<int64_t>(e / 2)
                       : -static_cast<int64_t>((e + 1) / 2);
    }
    values_out[k] = static_cast<int32_t>(s + t.offsets[idx]);
  }
  return kOk;
}

// --- Batch driver -----------------------------------------------------------

template <typename Fn>
int RunBatch(int64_t batch, int32_t num_threads, Fn&& fn) {
  if (batch <= 0) return kOk;
  int threads = num_threads <= 0 ? 1 : num_threads;
  threads = static_cast<int>(
      std::min<int64_t>(batch, std::min<int64_t>(threads, 64)));
  if (threads <= 1) {
    for (int64_t b = 0; b < batch; ++b) {
      int rc = fn(b);
      if (rc != kOk) return rc;
    }
    return kOk;
  }
  std::atomic<int> status{kOk};
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i) {
    pool.emplace_back([&] {
      int64_t b;
      while ((b = next.fetch_add(1)) < batch) {
        if (status.load(std::memory_order_relaxed) != kOk) return;
        int rc = fn(b);
        if (rc != kOk) status.store(rc);
      }
    });
  }
  for (auto& th : pool) th.join();
  return status.load();
}

}  // namespace
}  // namespace tpc

extern "C" {

int tpc_entropy_encode(const int32_t* values, const int32_t* indexes,
                       int64_t batch, int64_t n, const int32_t* cdfs,
                       const int32_t* cdf_lengths, const int32_t* cdf_offsets,
                       int32_t num_cdfs, int32_t max_len, int32_t precision,
                       uint8_t* out, int64_t capacity, int64_t* out_lens,
                       int32_t num_threads) {
  if (precision < 1 || precision > 16 || !values || !indexes || !cdfs)
    return tpc::kBadArgs;
  tpc::CdfTable t{cdfs, cdf_lengths, cdf_offsets, num_cdfs, max_len, precision};
  return tpc::RunBatch(batch, num_threads, [&](int64_t b) {
    std::vector<uint8_t> buf;
    buf.reserve(static_cast<size_t>(n) / 2 + 64);
    int rc = tpc::EncodeStream(values + b * n, indexes + b * n, n, t, &buf);
    if (rc != tpc::kOk) return rc;
    if (static_cast<int64_t>(buf.size()) > capacity) return tpc::kCapacityError;
    std::memcpy(out + b * capacity, buf.data(), buf.size());
    out_lens[b] = static_cast<int64_t>(buf.size());
    return tpc::kOk;
  });
}

int tpc_entropy_decode(const uint8_t* in, const int64_t* in_lens, int64_t batch,
                       int64_t capacity, int64_t n, const int32_t* indexes,
                       const int32_t* cdfs, const int32_t* cdf_lengths,
                       const int32_t* cdf_offsets, int32_t num_cdfs,
                       int32_t max_len, int32_t precision, int32_t* values_out,
                       int32_t num_threads) {
  if (precision < 1 || precision > 16 || !in || !indexes || !cdfs)
    return tpc::kBadArgs;
  tpc::CdfTable t{cdfs, cdf_lengths, cdf_offsets, num_cdfs, max_len, precision};
  return tpc::RunBatch(batch, num_threads, [&](int64_t b) {
    return tpc::DecodeStream(in + b * capacity, in_lens[b], indexes + b * n, n,
                             t, values_out + b * n);
  });
}

// Quantizes float64 PMF rows to integer CDF rows with total 2^precision.
// (Reference op: PmfToQuantizedCdf.) Every symbol is guaranteed frequency
// >= 1 so any symbol stays codable; surplus/deficit after rounding is
// settled greedily by the per-unit cross-entropy cost, deterministic with
// lowest-index tie-breaking.
//   pmf: [num_pmfs, max_pmf_len] row-major; row i uses pmf_lengths[i] entries.
//   cdf_out: [num_pmfs, max_pmf_len + 1]; row i has pmf_lengths[i]+1 valid
//   entries, cdf_out[i][0] = 0 and cdf_out[i][len] = 2^precision.
int tpc_pmf_to_quantized_cdf(const double* pmf, int64_t num_pmfs,
                             int64_t max_pmf_len, const int32_t* pmf_lengths,
                             int32_t precision, int32_t* cdf_out,
                             int32_t num_threads) {
  if (precision < 1 || precision > 16 || !pmf || !cdf_out) return tpc::kBadArgs;
  const int64_t total_target = int64_t{1} << precision;
  return tpc::RunBatch(num_pmfs, num_threads, [&](int64_t r) {
    const double* p = pmf + r * max_pmf_len;
    int32_t* cdf = cdf_out + r * (max_pmf_len + 1);
    const int32_t len = pmf_lengths[r];
    if (len < 1 || len > max_pmf_len || total_target < len) return tpc::kBadArgs;
    std::vector<double> prob(len);
    double sum = 0.0;
    for (int32_t i = 0; i < len; ++i) {
      prob[i] = p[i] > 0 && std::isfinite(p[i]) ? p[i] : 0.0;
      sum += prob[i];
    }
    if (sum <= 0) {  // degenerate: uniform
      for (int32_t i = 0; i < len; ++i) prob[i] = 1.0;
      sum = len;
    }
    std::vector<int64_t> q(len);
    int64_t total = 0;
    for (int32_t i = 0; i < len; ++i) {
      q[i] = std::max<int64_t>(
          1, std::llround(prob[i] / sum * static_cast<double>(total_target)));
      total += q[i];
    }
    // Cost of moving one unit into/out of symbol i (expected bits):
    //   gain(i)  = prob[i] * log((q+1)/q)     — for increments
    //   loss(i)  = prob[i] * log(q/(q-1))     — for decrements (q > 1)
    while (total != total_target) {
      if (total < total_target) {
        int32_t best = -1;
        double best_gain = -1.0;
        for (int32_t i = 0; i < len; ++i) {
          const double gain =
              prob[i] * std::log((q[i] + 1.0) / static_cast<double>(q[i]));
          if (gain > best_gain) {
            best_gain = gain;
            best = i;
          }
        }
        q[best] += 1;
        total += 1;
      } else {
        int32_t best = -1;
        double best_loss = 0.0;
        for (int32_t i = 0; i < len; ++i) {
          if (q[i] <= 1) continue;
          const double loss =
              prob[i] * std::log(static_cast<double>(q[i]) / (q[i] - 1.0));
          if (best < 0 || loss < best_loss) {
            best_loss = loss;
            best = i;
          }
        }
        if (best < 0) return tpc::kBadArgs;  // cannot shrink below len
        q[best] -= 1;
        total -= 1;
      }
    }
    cdf[0] = 0;
    for (int32_t i = 0; i < len; ++i)
      cdf[i + 1] = cdf[i] + static_cast<int32_t>(q[i]);
    return tpc::kOk;
  });
}

// --- Run-length + Elias-gamma coder for sparse integer tensors -------------
// (Reference ops: RunLengthGammaEncode/Decode.) Format, MSB-first bits:
//   repeat: gamma(zero_run + 1); if elements remain: gamma(|v|), sign bit.
namespace {

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int nbits = 0;
  void Put(uint32_t bit) {
    acc = (acc << 1) | (bit & 1);
    if (++nbits == 8) {
      bytes.push_back(static_cast<uint8_t>(acc));
      acc = 0;
      nbits = 0;
    }
  }
  void PutGamma(uint64_t v) {  // v >= 1
    int n = 63 - __builtin_clzll(v);
    for (int i = 0; i < n; ++i) Put(0);
    for (int i = n; i >= 0; --i) Put((v >> i) & 1);
  }
  void Flush() {
    while (nbits != 0) Put(0);
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;  // bit position
  uint32_t Get() {
    if (pos >= size * 8) return 0;
    uint32_t bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return bit;
  }
  uint64_t GetGamma() {
    int n = 0;
    while (Get() == 0) {
      if (++n > 62) return 0;
    }
    uint64_t v = 1;
    for (int i = 0; i < n; ++i) v = (v << 1) | Get();
    return v;
  }
};

}  // namespace

int tpc_run_length_gamma_encode(const int32_t* values, int64_t n, uint8_t* out,
                                int64_t capacity, int64_t* out_len) {
  if (!values || !out || !out_len) return tpc::kBadArgs;
  BitWriter w;
  int64_t i = 0;
  while (i < n) {
    int64_t run = 0;
    while (i < n && values[i] == 0) {
      ++run;
      ++i;
    }
    w.PutGamma(static_cast<uint64_t>(run) + 1);
    if (i < n) {
      const int64_t v = values[i];
      w.PutGamma(static_cast<uint64_t>(v < 0 ? -v : v));
      w.Put(v < 0 ? 1 : 0);
      ++i;
    }
  }
  w.Flush();
  if (static_cast<int64_t>(w.bytes.size()) > capacity)
    return tpc::kCapacityError;
  std::memcpy(out, w.bytes.data(), w.bytes.size());
  *out_len = static_cast<int64_t>(w.bytes.size());
  return tpc::kOk;
}

int tpc_run_length_gamma_decode(const uint8_t* in, int64_t in_len, int64_t n,
                                int32_t* values_out) {
  if (!in || !values_out) return tpc::kBadArgs;
  BitReader r{in, in_len};
  int64_t i = 0;
  while (i < n) {
    const uint64_t g = r.GetGamma();
    if (g == 0) return tpc::kCorrupt;
    int64_t run = static_cast<int64_t>(g) - 1;
    if (run > n - i) return tpc::kCorrupt;
    for (int64_t k = 0; k < run; ++k) values_out[i++] = 0;
    if (i < n) {
      const uint64_t mag = r.GetGamma();
      if (mag == 0) return tpc::kCorrupt;
      const uint32_t sign = r.Get();
      values_out[i++] =
          sign ? -static_cast<int32_t>(mag) : static_cast<int32_t>(mag);
    }
  }
  return tpc::kOk;
}

}  // extern "C"
