// Range coder core (arithmetic coding after G.N.N. Martin 1979).
//
// TPU-native framework equivalent of the reference's native coder
// (reference: tensorflow_compression/cc/kernels/range_coder.{h,cc}).
// This is an independent implementation using the classic byte-oriented
// carry-counting range coder (LZMA-style renormalization):
//   * 64-bit `low` accumulator (only the low 33 bits are ever live),
//     32-bit `range`.
//   * probabilities quantized to `precision` bits (1..16).
//   * renormalizes a byte at a time when range < 2^24; carries propagate
//     through a cache byte + run-of-0xFF counter, so output is exact.
//   * the first emitted byte is always 0 (the initial cache); the decoder
//     consumes it during its 5-byte priming read. Stream overhead is 5
//     bytes total (1 leading + 4 flush).
//
// The coder is fully deterministic: the bitstream format is defined by this
// file alone. The NumPy model (codec/_numpy_ref.py) implements the same
// format; tests fuzz their bit-exact equivalence.

#ifndef COMPRESSION_TPU_CODEC_RANGE_CODER_H_
#define COMPRESSION_TPU_CODEC_RANGE_CODER_H_

#include <cstddef>
#include <cstdint>
#include <vector>

namespace tpc {

constexpr uint32_t kTopValue = 1u << 24;

class RangeEncoder {
 public:
  explicit RangeEncoder(std::vector<uint8_t>* out) : out_(out) {}

  // Encodes a symbol occupying [cum, cum + freq) out of 2^precision.
  // Requires freq > 0 and cum + freq <= 2^precision.
  inline void Encode(uint32_t cum, uint32_t freq, int precision) {
    const uint32_t r = range_ >> precision;
    low_ += static_cast<uint64_t>(r) * cum;
    range_ = r * freq;
    while (range_ < kTopValue) {
      ShiftLow();
      range_ <<= 8;
    }
  }

  // Encodes a single raw bit with a uniform model (precision 1).
  inline void EncodeBit(uint32_t bit) { Encode(bit, 1, 1); }

  // Flushes the coder state. Must be called exactly once.
  inline void Finalize() {
    for (int i = 0; i < 5; ++i) ShiftLow();
  }

 private:
  inline void ShiftLow() {
    if (static_cast<uint32_t>(low_ >> 32) != 0 ||
        static_cast<uint32_t>(low_) < 0xFF000000u) {
      const uint8_t carry = static_cast<uint8_t>(low_ >> 32);
      uint8_t byte = cache_;
      do {
        out_->push_back(static_cast<uint8_t>(byte + carry));
        byte = 0xFF;
      } while (--cache_size_ != 0);
      cache_ = static_cast<uint8_t>(low_ >> 24);
    }
    ++cache_size_;
    low_ = static_cast<uint64_t>(static_cast<uint32_t>(low_) << 8);
  }

  std::vector<uint8_t>* out_;
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  uint64_t cache_size_ = 1;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* data, size_t size) : data_(data), size_(size) {
    for (int i = 0; i < 5; ++i) code_ = (code_ << 8) | NextByte();
  }

  // Returns the cumulative-frequency slot of the next symbol; the caller
  // maps it to a symbol via its CDF and then calls Update with that
  // symbol's (cum, freq).
  inline uint32_t DecodeFreq(int precision) {
    r_ = range_ >> precision;
    const uint32_t f = code_ / r_;
    const uint32_t max_f = (1u << precision) - 1;
    return f > max_f ? max_f : f;
  }

  inline void Update(uint32_t cum, uint32_t freq) {
    code_ -= r_ * cum;
    range_ = r_ * freq;
    while (range_ < kTopValue) {
      code_ = (code_ << 8) | NextByte();
      range_ <<= 8;
    }
  }

  inline uint32_t DecodeBit() {
    const uint32_t f = DecodeFreq(1);
    Update(f, 1);
    return f;
  }

 private:
  inline uint8_t NextByte() { return pos_ < size_ ? data_[pos_++] : 0; }

  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint32_t code_ = 0;  // 32-bit window; the leading 0 byte shifts out.
  uint32_t range_ = 0xFFFFFFFFu;
  uint32_t r_ = 0;
};

}  // namespace tpc

#endif  // COMPRESSION_TPU_CODEC_RANGE_CODER_H_
