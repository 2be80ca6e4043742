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
// Element j of an image belongs to lane k = j mod K at step t = j div K;
// T = ceil(N / K). Measured times and their floors are in PERF.md.
//
// Bound on an H100 SXM: per element the coder moves a few bytes and does
// some twenty integer operations, so by the roofline a batch is microseconds
// of work, bound by bytes. What bounds a kernel is its serial chain: each
// lane's state passes through T dependent steps, and in the decoder every
// step also waits on all lanes, because the stream interleaves their words
// in lane order. Only one warp a scheduler runs each chain, so a step costs
// the latency of its instructions, not their throughput. K stays 128: the
// blob stores K and the JAX package picks it (models/device_coding.py
// rans_for), so a larger K, or lanes split across CTAs in a way that
// changes the interleaving, would change the bitstream. The designs below
// shorten each step instead.
//
// K3, encoder: two launches.
//  1. rans_fields_kernel, over the whole card: each element's fields, which
//     do not depend on the state (escape flag, payload, f and c from the
//     table blob through L1), as one 8-byte record.
//  2. rans_encode_kernel, one CTA of 512 threads an image:
//     * Lane pass. Thread k walks lane k from t = T-1 down to 0 with no
//       barrier and no shared counter: nothing in the encoder couples lanes
//       except where their words land. Records load two groups of eight
//       steps ahead, so the chain of a step is the escape substitution, the
//       renorm test and the state update (native u32 '/' and '%': exact,
//       with the divisor's reciprocal off the chain; a multiply-high by
//       host-built multipliers needed 16-byte records and ran slower, see
//       PERF.md). Each step stores its
//       three candidate words in rec[t][slot][k] (slot 0 main, 1 payload-lo,
//       2 payload-hi) and its warp's two ballots (em, esc) in
//       flags[t][k / 32], with no branch.
//     * Compaction, after one block barrier. In decode order the stream is
//       the head (lane states, 2K words), then for t = 0 .. T-1 the step's
//       main, payload-lo and payload-hi words, each in ascending lane order:
//       the reversal of the emission order (t descending, hi, lo, main,
//       lanes descending, then the flush). Chunks of flags are staged in
//       shared memory; a block-wide scan of the steps' word counts gives
//       each step's start, and each thread places its own steps' words.
//       Words at or past cap are dropped, as the JAX scatter keeps words
//       with total-1-i < cap; the wrapper passes out zeroed.
//
// K2, decoder: one CTA an image, NW decoder warps (4 up to K = 128, else
// 16; one lane a thread, two past 512 lanes) and one producer warp.
//  * Tables on chip (the "on_chip" variant): the table blob (row info, f|c
//    stored ragged with a sentinel per row, and per-row buckets of
//    2^bucket_bits slots holding their first symbol) is copied into shared
//    memory by one bulk copy (TMA, cp.async.bulk). A symbol is the bucket's
//    first symbol, or (rarely) one found by a forward search through the
//    row's f|c. Tables too large for the budget take the "global" variant
//    of the same kernel, which reads the blob through L1.
//  * The producer warp keeps two rings in shared memory ahead of the
//    decoder warps: the stream's words (8,192; positions at or past cap read
//    stream[cap-1], as rans.py:283 clips), handed over by acquire/release
//    flags, and the rows, a chunk of steps per slot, each by one bulk copy
//    where aligned, handed over by full/empty mbarriers.
//  * A step's word ranks are ballots and popcounts within a warp, plus the
//    warps' counts exchanged over a named barrier of the decoder warps
//    only: no block barrier in the loop.
//  So the chain of a step is: slot -> bucket -> f|c -> state update ->
//  ballot -> counts over the named barrier -> stream word -> state, every
//  load from shared memory in the on_chip variant. The next step's rows and
//  row info load in between, in the same block of code.
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
constexpr int kMaxLanes = 1024;

// Table blob (RansTables.blob on the host, int32 words, 16-byte padded):
//   rowinfo int4[R]: {fc start, escape E, cdf offset, bucket base}
//   fcr u32: row r's symbols m = 0 .. n_r - 2 as f << 16 | c at fc start + m,
//            then a sentinel 1 << P (c = 2^P: no slot lies past it)
//   bucket u16[R << (P - bucket_bits)] (decoder only): the symbol holding
//            slot i << bucket_bits of the row
struct Blob {
  const int4* rowinfo;
  const uint32_t* fcr;
  const uint16_t* bucket;
  int num_rows;
  int precision;
  int bucket_bits;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename RowT>
__device__ __forceinline__ int clip_row(RowT raw, int num_rows) {
  // jnp.take(..., mode="clip") on the row tables.
  const int r = static_cast<int>(raw);
  return min(max(r, 0), num_rows - 1);
}

// ---------------------------------------------------------------------------
// Shared helpers: acquire/release flags and mbarriers in shared memory, and
// the bulk copy (TMA) that stages tables and rows.

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
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

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes bar's phase together with its expect_tx.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0 copies the table blob's first `bytes` into shared memory; every
// caller returns once it is there. bar must be initialised (count 1) and
// fenced before.
__device__ __forceinline__ void stage_tables(void* dst, const void* blob,
                                             uint32_t bytes, uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bytes);
    bulk_load(dst, blob, bytes, bar);
  }
  mbar_wait(bar, 0);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

template <bool kOnChip, typename X>
__device__ __forceinline__ X tload(const X* p) {
  if constexpr (kOnChip) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// ---------------------------------------------------------------------------
// K3: encoder.

constexpr int kEncThreads = 512;
constexpr int kEncWarps = kEncThreads / kWarp;
constexpr int kEncGroup = 8;          // steps a lane runs between loads
constexpr int kEncFlagChunk = 16384;  // (em, esc) pairs staged per chunk
constexpr uint32_t kEscBit = 1u << 15;  // free in f|c: c < 2^P <= 2^15

// Launch 1: every element's fields, which do not depend on the state
// (rans.py _element_fields + the fc gather): fields[j] = {f|c, with the
// escape flag in bit 15; the escape payload e}. Tables through L1.
template <typename RowT>
__global__ void __launch_bounds__(kEncThreads)
    rans_fields_kernel(const int32_t* __restrict__ values, const RowT* __restrict__ rows,
                       Blob tb, long long count, uint2* __restrict__ fields) {
  for (long long j = blockIdx.x * static_cast<long long>(kEncThreads) + threadIdx.x;
       j < count; j += static_cast<long long>(gridDim.x) * kEncThreads) {
    const int4 info = __ldg(tb.rowinfo + clip_row(__ldg(rows + j), tb.num_rows));
    const int32_t E = info.y;
    const int32_t s = static_cast<int32_t>(static_cast<uint32_t>(__ldg(values + j)) -
                                           static_cast<uint32_t>(info.z));
    const bool in_range = s >= 0 && s < E;
    const uint32_t e = s >= E ? (static_cast<uint32_t>(s) - static_cast<uint32_t>(E)) * 2u
                              : (0u - static_cast<uint32_t>(s)) * 2u - 1u;
    const uint32_t fcv = __ldg(tb.fcr + info.x + (in_range ? s : E));
    fields[j] = make_uint2(fcv | (in_range ? 0u : kEscBit), e);
  }
}

// Lane k's pass over t = T-1 .. 0 (the whole warp calls it together): the
// fields of group g+2 load while group g's chain runs, in one branch-free
// block. Step bookkeeping is 32-bit and incremental (n < 2^31).
__device__ __forceinline__ void encode_lane(const uint2* __restrict__ f_img, int n,
                                            int lanes, int k, int T, int P,
                                            uint16_t* rec_img, uint2* flags_img, int W,
                                            uint32_t* xs) {
  constexpr int U = kEncGroup;
  const int lane = threadIdx.x % kWarp;
  const bool has_lane = k < lanes;
  // Lanes with an element at step T-1 (the only ragged step).
  const int last = has_lane ? n - (T - 1) * lanes : 0;
  auto load = [&](int g, uint2 (&fl)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = T - 1 - (g * U + u);
      const bool here = has_lane && t >= 0 && (t < T - 1 || k < last);
      fl[u] = here ? __ldg(f_img + static_cast<long long>(t) * lanes + k)
                   : make_uint2(kEscBit, 0u);
    }
  };

  uint32_t x = kL;
  const int groups = (T + U - 1) / U;
  uint2 f0[U], f1[U], f2[U];
  load(0, f0);
  load(1, f1);
  uint16_t* rec_t = rec_img + static_cast<long long>(T - 1) * 3 * lanes + k;
  uint2* flag_t = flags_img + static_cast<long long>(T - 1) * W + (k >> 5);
  int t = T - 1;
  for (int g = 0; g < groups; ++g) {
    load(g + 2, f2);
#pragma unroll
    for (int u = 0; u < U; ++u, --t) {
      const bool valid = has_lane && t >= 0 && (t < T - 1 || k < last);
      const bool esc = valid && (f0[u].x & kEscBit);
      const uint32_t f = f0[u].x >> 16;
      const uint32_t c = f0[u].x & (kEscBit - 1);
      const uint32_t e = f0[u].y;
      // Pushes: payload-hi and payload-lo (escapes only: each emits the
      // state's low word and replaces it), then the main push, which
      // renormalises first, emitting the low word iff x >= f << (32 - P),
      // tested as a shift of x so a full-mass row (f == 2^P) cannot wrap.
      const uint16_t v_hi = static_cast<uint16_t>(x & kM16);
      if (esc) x = (x & kHi16) | (e & kM16);
      const bool em = valid && (x >> (32 - P)) >= f;
      const uint16_t v_m = static_cast<uint16_t>(x & kM16);
      if (em) x >>= 16;
      // f == 0 cannot be coded (no table row gives a coded symbol zero
      // mass); the clamp only keeps the division defined.
      const uint32_t fs = f ? f : 1u;
      const uint32_t x2 = ((x / fs) << P) + x % fs + c;
      x = valid ? x2 : x;
      const unsigned b_em = __ballot_sync(kFull, em);
      const unsigned b_esc = __ballot_sync(kFull, esc);
      // All three candidates of an element, flagged or not (no branch).
      if (valid) {
        rec_t[0] = v_m;
        rec_t[lanes] = static_cast<uint16_t>(e >> 16);
        rec_t[2 * lanes] = v_hi;
      }
      if (lane == 0 && t >= 0) *flag_t = make_uint2(b_em, b_esc);
      rec_t -= 3 * lanes;
      flag_t -= W;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      f0[u] = f1[u];
      f1[u] = f2[u];
    }
  }
  if (has_lane) xs[k] = x;
}

__device__ __forceinline__ int step_count(const uint2* fl, int W) {
  int cnt = 0;
  for (int w = 0; w < W; ++w) cnt += __popc(fl[w].x) + 2 * __popc(fl[w].y);
  return cnt;
}

// Places step t's words from position pos on (main, then payload-lo, then
// payload-hi, each in ascending lane order); words at or past cap are cut.
__device__ __forceinline__ void place_step(const uint2* fl, int W,
                                           const uint16_t* rec_t, int lanes,
                                           uint16_t* o, long long cap,
                                           long long pos) {
  int n_em = 0, n_esc = 0;
  for (int w = 0; w < W; ++w) {
    n_em += __popc(fl[w].x);
    n_esc += __popc(fl[w].y);
  }
  long long pm = pos, pl = pos + n_em, ph = pos + n_em + n_esc;
  for (int w = 0; w < W; ++w) {
    const uint2 f = fl[w];
    for (unsigned m = f.x; m; m &= m - 1, ++pm) {
      if (pm < cap) o[pm] = rec_t[w * kWarp + __ffs(m) - 1];
    }
    for (unsigned m = f.y; m; m &= m - 1, ++pl, ++ph) {
      const int k = w * kWarp + __ffs(m) - 1;
      if (pl < cap) o[pl] = rec_t[lanes + k];
      if (ph < cap) o[ph] = rec_t[2 * lanes + k];
    }
  }
}

// Launch 2, one CTA an image. fields: [B][N] from launch 1; rec: [B][T][3][K]
// u16, flags: [B][T][W] (em, esc ballots), both written and read back by
// this kernel (plain loads, not the read-only path). out holds zeros on
// entry; the kernel writes [0, min(total, cap)). Dynamic shared memory: a
// chunk of flags during the compaction.
__global__ void __launch_bounds__(kEncThreads, 1)
    rans_encode_kernel(const uint2* __restrict__ fields, int precision, long long n,
                       int lanes, long long cap, uint16_t* rec, uint2* flags,
                       uint16_t* __restrict__ out, int32_t* __restrict__ lengths,
                       uint8_t* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char esm[];
  __shared__ uint32_t xs[kMaxLanes];
  __shared__ int warp_sums[kEncWarps];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const long long b = blockIdx.x;
  const long long T = (n + lanes - 1) / lanes;
  const int W = (lanes + kWarp - 1) / kWarp;
  uint16_t* rec_img = rec + b * T * 3 * lanes;
  uint2* flags_img = flags + b * T * W;
  uint16_t* o = out + b * cap;

  // 1. Lane pass: lane k = kb + tid, no barrier.
  for (int kb = 0; kb < lanes; kb += kEncThreads) {
    if (kb + warp * kWarp < lanes) {
      encode_lane(fields + b * n, static_cast<int>(n), lanes, kb + tid,
                  static_cast<int>(T), precision, rec_img, flags_img, W, xs);
    }
  }
  __syncthreads();

  // 2. Compaction, a chunk of steps at a time: the chunk's flags into
  // shared memory, a block-wide exclusive scan of the steps' word counts,
  // then each thread places its own steps' words. A thread takes
  // per_thread consecutive steps (as few as cover T; >= 1 as W <= 32), and
  // the staged flags skip one pair after each thread's steps, so a warp's
  // reads fall in different banks.
  uint2* sfl = reinterpret_cast<uint2*>(esm);
  const int per_thread = static_cast<int>(
      min(static_cast<long long>(kEncFlagChunk / (W * kEncThreads)),
          (T + kEncThreads - 1) / kEncThreads));
  const int chunk_steps = per_thread * kEncThreads;
  auto flags_of = [&](int s) { return sfl + s * W + s / per_thread; };
  long long base = 2LL * lanes;  // the head comes first
  for (long long c0 = 0; c0 < T; c0 += chunk_steps) {
    const int steps = static_cast<int>(min(static_cast<long long>(chunk_steps), T - c0));
    const uint2* gfl = flags_img + c0 * W;
#pragma unroll 8
    for (int i = tid; i < steps * W; i += kEncThreads) sfl[i + i / W / per_thread] = gfl[i];
    __syncthreads();
    const int s0 = tid * per_thread;
    int tot = 0;
    for (int s = s0; s < min(s0 + per_thread, steps); ++s) tot += step_count(flags_of(s), W);
    int incl = tot;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == kWarp - 1) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kEncWarps; ++w) {
      const int ws = warp_sums[w];
      before += w < warp ? ws : 0;
      chunk += ws;
    }
    long long pos = base + before + incl - tot;
    for (int s = s0; s < min(s0 + per_thread, steps); ++s) {
      place_step(flags_of(s), W, rec_img + (c0 + s) * 3 * lanes, lanes, o, cap, pos);
      pos += step_count(flags_of(s), W);
    }
    base += chunk;
    __syncthreads();  // sfl and warp_sums are reused
  }
  const long long total = base;

  // 3. The head: the flushed lane states, word[2k] = hi, word[2k+1] = lo.
  for (int k = tid; k < lanes; k += kEncThreads) {
    const uint32_t x = xs[k];
    if (2LL * k < cap) o[2 * k] = static_cast<uint16_t>(x >> 16);
    if (2LL * k + 1 < cap) o[2 * k + 1] = static_cast<uint16_t>(x & kM16);
  }
  if (tid == 0) {
    lengths[b] = static_cast<int32_t>(total);
    overflow[b] = total > cap;
  }
}

// ---------------------------------------------------------------------------
// K2: decoder.

constexpr int kMaxDecWarps = 16;        // decoder warps; LPT = 2 past 512 lanes
constexpr int kRingWords = 8192;        // stream ring (u16 words)
constexpr uint32_t kRingMask = kRingWords - 1;
constexpr int kChunkWords = 512;        // the producer's stream refill unit
constexpr int kRowSlots = 4;            // rows ring: chunks of steps in flight
constexpr int kRowSlotBytes = 8192;     // a chunk: 2,048 int32 rows
constexpr int kCtrlBytes = 512;
constexpr int kDecFixedSmem = kCtrlBytes + 2 * kRingWords + kRowSlots * kRowSlotBytes;
constexpr int kMaxSmem = 232448;        // a block's dynamic shared memory
constexpr int kLaneBarrier = 1;         // named barrier of the decoder warps

// ctrl words: the producer publishes kFilled (stream words in the ring);
// the decoder publishes kConsumed (stream words it no longer needs), kOk
// and kDone. The mbarriers sit from byte 64: the table copy's, then per
// rows slot one "full" (the producer's fill landed) and one "empty" (the
// decoder has read the chunk); the warps' per-step counts from byte 192,
// [2 (step parity)][LPT][warps], words needed | escapes << 16.
enum { kFilled = 0, kConsumed = 1, kDone = 2, kOk = 3 };
constexpr int kBarOffset = 64;
constexpr int kCountOffset = 192;

// Steps a rows chunk holds: kRowSlotBytes of int32 rows of `span` lanes.
__host__ __device__ constexpr int row_chunk_steps(int span) {
  return kRowSlotBytes / (4 * span);
}

__device__ __forceinline__ void lane_barrier(int warps) {
  asm volatile("bar.sync %0, %1;" ::"n"(kLaneBarrier), "r"(warps * kWarp) : "memory");
}

// The producer warp: keeps the stream ring filled ahead of the decoder
// (plain loads; reads at or past cap clipped to stream[cap-1]) and the rows
// ring, one chunk of steps per slot: one bulk copy where the chunk's bytes
// are 16-byte aligned (the main path's are), else the warp's loads.
template <int kLaneWarps>  // warps' worth of lanes the decoder holds
__device__ void produce(const uint16_t* __restrict__ st, long long cap,
                        const unsigned char* __restrict__ rows, int row_bytes,
                        long long n, int lanes, long long T, uint32_t* ctrl,
                        uint64_t* full, uint16_t* ring, unsigned char* rring) {
  constexpr int RB = row_chunk_steps(kLaneWarps * kWarp);
  constexpr int kPerWord = kChunkWords / kWarp;
  const int l = threadIdx.x % kWarp;
  const long long chunks = (T + RB - 1) / RB;
  uint32_t wfill = 0;
  long long c = 0;  // next rows chunk
  while (true) {
    bool busy = false;
    if (static_cast<int>(wfill + kChunkWords - ld_acquire(ctrl + kConsumed)) <= kRingWords) {
      uint16_t w[kPerWord];
#pragma unroll
      for (int q = 0; q < kPerWord; ++q) {
        const long long pos = static_cast<long long>(wfill) + q * kWarp + l;
        w[q] = __ldg(st + min(pos, cap - 1));
      }
#pragma unroll
      for (int q = 0; q < kPerWord; ++q) ring[(wfill + q * kWarp + l) & kRingMask] = w[q];
      __syncwarp();
      if (l == 0) st_release(ctrl + kFilled, wfill + kChunkWords);
      wfill += kChunkWords;
      busy = true;
    }
    const int slot = static_cast<int>(c % kRowSlots);
    if (c < chunks && (c < kRowSlots ||
                       mbar_test(full + kRowSlots + slot, ((c / kRowSlots) + 1) & 1))) {
      unsigned char* dst = rring + slot * kRowSlotBytes;
      const long long j0 = c * RB * lanes;
      const long long count = min(static_cast<long long>(RB) * lanes, n - j0);
      const unsigned char* src = rows + j0 * row_bytes;
      const uint32_t bytes = static_cast<uint32_t>(count * row_bytes);
      if (((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0) {
        if (l == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(full + slot, bytes);
          bulk_load(dst, src, bytes, full + slot);
        }
      } else {
        // Eight loads in flight a thread, at clamped (always valid) bytes.
        for (uint32_t q0 = 0; q0 < bytes; q0 += 8 * kWarp) {
          unsigned char v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __ldg(src + min(q0 + u * kWarp + l, bytes - 1));
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (q0 + u * kWarp + l < bytes) dst[q0 + u * kWarp + l] = v[u];
          }
        }
        __syncwarp();
        if (l == 0) mbar_arrive(full + slot);
      }
      ++c;
      busy = true;
    }
    if (ld_acquire(ctrl + kDone)) break;
    if (!busy) __nanosleep(512);  // it shares a scheduler with decoder warp 0
  }
}

// The NW decoder warps: lane k = 32 (NW i + w) + l is lane l of warp w's
// i-th set (i < LPT).
template <int NW, int LPT, bool kOnChip>
__device__ void decode_lanes(const Blob& tb, uint32_t* ctrl, uint64_t* full,
                             const uint16_t* ring, const unsigned char* rring,
                             int row_bytes, int T, long long n, int lanes,
                             int32_t* __restrict__ out_img, uint8_t* __restrict__ ok_b) {
  constexpr int span = NW * kWarp;  // lanes a set covers
  constexpr int RB = row_chunk_steps(LPT * span);
  const int w = threadIdx.x / kWarp;
  const int l = threadIdx.x % kWarp;
  const unsigned below = (1u << l) - 1u;
  const int P = tb.precision;
  const uint32_t pmask = (1u << P) - 1u;
  const int bb = tb.bucket_bits;
  uint32_t* counts = ctrl + kCountOffset / 4;

  // The head: lane k's state is word[2k] << 16 | word[2k+1].
  uint32_t filled = 0;
  const uint32_t head = 2u * static_cast<uint32_t>(lanes);
  while (static_cast<int>(head - filled) > 0) filled = ld_acquire(ctrl + kFilled);
  uint32_t x[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int k = i * span + w * kWarp + l;
    x[i] = k < lanes ? (static_cast<uint32_t>(ring[2 * k]) << 16) | ring[2 * k + 1] : kL;
  }
  uint32_t p = head, published = 0;

  // The rows ring, read one step ahead: the next step to read is step rts
  // of the chunk in rows slot rslot, whose fill has phase rphase. The
  // cursor moves by selects, and the wait for a chunk's fill happens at the
  // end of the step before, so a step's common path is one block.
  int rts = 0, rslot = 0;
  uint32_t rphase = 0;
  auto advance = [&]() {
    const bool wrap = ++rts == RB;
    rts = wrap ? 0 : rts;
    rslot = wrap ? (rslot + 1) & (kRowSlots - 1) : rslot;
    rphase ^= wrap && rslot == 0;
  };
  auto raw_row = [&](int i) {
    const unsigned char* rr = rring + rslot * kRowSlotBytes;
    const int e = rts * lanes + i * span + w * kWarp + l;  // in the slot even past K
    return row_bytes == 1 ? rr[e] : reinterpret_cast<const int32_t*>(rr)[e];
  };
  auto info_of = [&](int raw) { return tload<kOnChip>(tb.rowinfo + clip_row(raw, tb.num_rows)); };

  // Lanes with an element at step T-1 (the only ragged step).
  const int last = static_cast<int>(n - (T - 1) * lanes);
  uint64_t* empty = full + kRowSlots;
  int4 cur[LPT];
  if (T > 0) {
    mbar_wait(full, 0);
#pragma unroll
    for (int i = 0; i < LPT; ++i) cur[i] = info_of(raw_row(i));
    advance();
    if (rts == 0 && T > 1) mbar_wait(full + rslot, rphase);
  }
  int32_t* out_t = out_img + w * kWarp + l;
  for (int t = 0; t < T; ++t, out_t += lanes) {
    const int have = t < T - 1 ? lanes : last;
    const bool chunk_read = rts == RB - 1;  // this prefetch ends a chunk

    // Main pop: slot -> symbol (the bucket's first symbol, then forward
    // through the row's f|c, rarely past it), then the state update; the
    // next step's rows and row info load in between (off the chain).
    uint32_t slot[LPT], m[LPT], a[LPT], nx[LPT];
    int raw[LPT];
    unsigned valid_bits = 0, adv = 0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      valid_bits |= static_cast<unsigned>(i * span + w * kWarp + l < have) << i;
      slot[i] = x[i] & pmask;
      m[i] = tload<kOnChip>(tb.bucket + cur[i].w + (slot[i] >> bb));
      raw[i] = raw_row(i);
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      a[i] = tload<kOnChip>(tb.fcr + cur[i].x + m[i]);
      nx[i] = tload<kOnChip>(tb.fcr + cur[i].x + m[i] + 1);
    }
    int4 nxt[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      nxt[i] = info_of(raw[i]);
      adv |= static_cast<unsigned>((nx[i] & kM16) <= slot[i]) << i;
    }
    while (adv) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if ((adv >> i) & 1u) {
          a[i] = nx[i];
          ++m[i];
          nx[i] = tload<kOnChip>(tb.fcr + cur[i].x + m[i] + 1);
          if ((nx[i] & kM16) > slot[i]) adv &= ~(1u << i);
        }
      }
    }
    uint32_t x1[LPT];
    unsigned bn[LPT], be[LPT];
    const int par = t & 1;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const uint32_t xx = (a[i] >> 16) * (x[i] >> P) + slot[i] - (a[i] & kM16);
      const bool valid = (valid_bits >> i) & 1u;
      x1[i] = valid ? xx : x[i];
      bn[i] = __ballot_sync(kFull, valid && xx < kL);
      be[i] = __ballot_sync(kFull, valid && static_cast<int32_t>(m[i]) == cur[i].y);
      if (l == 0) counts[(par * LPT + i) * kMaxDecWarps + w] = __popc(bn[i]) | __popc(be[i]) << 16;
    }

    // Ranks in ascending lane order: the warps' counts of this step, over
    // the named barrier of the decoder warps (the producer is not in it).
    lane_barrier(NW);
    uint32_t before[LPT], total = 0;  // words needed | escapes << 16
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const uint32_t* ci = counts + (par * LPT + i) * kMaxDecWarps;
      before[i] = total;
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        const uint32_t cv = ci[v];
        before[i] += v < w ? cv : 0;
        total += cv;
      }
    }
    const uint32_t n_need = total & kM16, n_esc = total >> 16;
    const uint32_t p0 = p, p1 = p + n_need;
    const uint32_t p_end = p1 + 2 * n_esc;
    if (static_cast<int>(p_end - filled) > 0) {
      do {
        filled = ld_acquire(ctrl + kFilled);
      } while (static_cast<int>(p_end - filled) > 0);
    }
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const uint32_t rn = (before[i] & kM16) + __popc(bn[i] & below);
      x[i] = (bn[i] >> l) & 1u ? (x1[i] << 16) | ring[(p + rn) & kRingMask] : x1[i];
    }
    if (n_esc) {
      // Bypass pops: payload-lo reads at p1 + rank, payload-hi at p1 +
      // n_esc + rank; e = (hi << 16) | lo.
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        if ((be[i] >> l) & 1u) {
          const uint32_t re = (before[i] >> 16) + __popc(be[i] & below);
          const uint32_t w1 = ring[(p1 + re) & kRingMask];
          const uint32_t w2 = ring[(p1 + n_esc + re) & kRingMask];
          const uint32_t e = (w1 << 16) | (x[i] & kM16);
          x[i] = (x[i] & kHi16) | w2;
          // e even: s = E + e/2; e odd: s = -(e/2 + 1) = ~(e/2); int32 wrap.
          m[i] = (e & 1u) == 0 ? static_cast<uint32_t>(cur[i].y) + (e >> 1) : ~(e >> 1);
        }
      }
    }
    p = p_end;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      if ((valid_bits >> i) & 1u) {
        out_t[i * span] = static_cast<int32_t>(m[i] + static_cast<uint32_t>(cur[i].z));
      }
      cur[i] = nxt[i];
    }

    // Past the barrier every warp has read this step's prefetched rows and
    // finished step t-1: free a whole chunk's slot, hand back the stream
    // words before p0, and wait for the chunk the next prefetch starts.
    advance();
    if (w == 0 && l == 0) {
      if (chunk_read) mbar_arrive(empty + ((rslot - 1) & (kRowSlots - 1)));
      if (static_cast<int>(p0 - published) >= kChunkWords) {
        st_release(ctrl + kConsumed, p0);
        published = p0;
      }
    }
    if (rts == 0 && t + 2 < T) mbar_wait(full + rslot, rphase);
  }
  bool fine = true;
#pragma unroll
  for (int i = 0; i < LPT; ++i) fine = fine && x[i] == kL;
  if (!__all_sync(kFull, fine) && l == 0) ctrl[kOk] = 0;
  lane_barrier(NW);
  if (w == 0 && l == 0) {
    *ok_b = static_cast<uint8_t>(ctrl[kOk]);
    st_release(ctrl + kDone, 1);
  }
}

// Block: NW decoder warps, then the producer warp.
template <int NW, int LPT, bool kOnChip>
__global__ void __launch_bounds__((NW + 1) * kWarp, 1)
    rans_decode_kernel(const uint16_t* __restrict__ stream, long long cap,
                       const unsigned char* __restrict__ rows, int row_bytes, Blob tb,
                       int table_bytes, int fc_words, int bucket_words, long long n,
                       int lanes, int32_t* __restrict__ values, uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ctrl = reinterpret_cast<uint32_t*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);  // table, full[slots]
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kCtrlBytes);
  unsigned char* rring = smem + kCtrlBytes + 2 * kRingWords;
  unsigned char* tsm = smem + kDecFixedSmem;

  const long long b = blockIdx.x;
  const long long T = (n + lanes - 1) / lanes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBarOffset / 4; ++i) ctrl[i] = 0;
    ctrl[kOk] = 1;
  }
  init_barriers(bars, 1 + 2 * kRowSlots);
  __syncthreads();  // the only block barrier: the roles split here
  if (threadIdx.x < NW * kWarp) {
    if constexpr (kOnChip) {
      stage_tables(tsm, tb.rowinfo, static_cast<uint32_t>(table_bytes), bars);
      tb.rowinfo = reinterpret_cast<const int4*>(tsm);
      tb.fcr = reinterpret_cast<const uint32_t*>(tsm) + fc_words;
      tb.bucket = reinterpret_cast<const uint16_t*>(
          reinterpret_cast<const uint32_t*>(tsm) + bucket_words);
    }
    decode_lanes<NW, LPT, kOnChip>(tb, ctrl, bars + 1, ring, rring, row_bytes,
                                   static_cast<int>(T), n, lanes, values + b * n, ok + b);
  } else {
    produce<NW * LPT>(stream + b * cap, cap, rows + b * n * row_bytes, row_bytes, n, lanes,
                      T, ctrl, bars + 1, ring, rring);
  }
}

bool bad_args(int num_rows, int precision, int bucket_bits, int batch, long long n,
              int lanes) {
  // Steps and positions within an image are 32-bit: n < 2^31, and the
  // stream of an image (at most 3n + 2K words) stays under 2^32.
  return num_rows < 1 || precision < 1 || precision > 15 || bucket_bits < 0 ||
         bucket_bits > precision || batch < 1 || n < 0 || n > 0x50000000LL ||
         lanes < 1 || lanes > kMaxLanes;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int NW, int LPT, bool kOnChip>
cudaError_t launch_decode(int batch, int smem, cudaStream_t s, const uint16_t* words,
                          long long cap, const unsigned char* rows, int row_bytes,
                          Blob tb, int table_bytes, int fc_words, int bucket_words,
                          long long n, int lanes, int32_t* values, uint8_t* ok) {
  auto kernel = rans_decode_kernel<NW, LPT, kOnChip>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, (NW + 1) * kWarp, smem, s>>>(words, cap, rows, row_bytes, tb,
                                               table_bytes, fc_words, bucket_words, n,
                                               lanes, values, ok);
  return cudaGetLastError();
}

bool bad_blob(const void* blob, int bytes) {
  return bytes < 16 || bytes % 16 != 0 || (reinterpret_cast<uintptr_t>(blob) & 15) != 0;
}

}  // namespace

extern "C" {

// values i32 [batch][n], rows u8 or i32 [batch][n] (rows_u8 says which),
// blob: the table blob (device, int32 words; row info at 0, f|c at
// fc_words), fields u32 [batch][n][2], rec u16 [batch][T][3][lanes], flags
// u32 [batch][T][ceil(lanes / 32)][2], out u16 [batch][cap] (zeros on
// entry), lengths i32 [batch], overflow u8 [batch]. Two launches: the
// fields over the whole card, then one CTA an image.
int tpc_rans_encode(const void* values, const void* rows, int rows_u8,
                    const void* blob, int fc_words, int num_rows, int precision,
                    int batch, long long n, int lanes, long long cap, void* fields,
                    void* rec, void* flags, void* out, void* lengths, void* overflow,
                    int sms, void* stream) {
  if (bad_args(num_rows, precision, 0, batch, n, lanes) || cap < 1 || fc_words < 0 ||
      sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Blob tb{static_cast<const int4*>(blob),
                static_cast<const uint32_t*>(blob) + fc_words, nullptr, num_rows,
                precision, 0};
  auto s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const int32_t*>(values);
  auto* fl = static_cast<uint2*>(fields);
  const long long count = batch * n;
  if (count > 0) {
    const int grid = static_cast<int>(
        min(static_cast<long long>(sms) * 8, (count + kEncThreads - 1) / kEncThreads));
    if (rows_u8) {
      rans_fields_kernel<uint8_t><<<grid, kEncThreads, 0, s>>>(
          v, static_cast<const uint8_t*>(rows), tb, count, fl);
    } else {
      rans_fields_kernel<int32_t><<<grid, kEncThreads, 0, s>>>(
          v, static_cast<const int32_t*>(rows), tb, count, fl);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = (kEncFlagChunk + kEncThreads) * 8;
  const cudaError_t err = allow_smem(rans_encode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_encode_kernel<<<batch, kEncThreads, smem, s>>>(
      fl, precision, n, lanes, cap, static_cast<uint16_t*>(rec), static_cast<uint2*>(flags),
      static_cast<uint16_t*>(out), static_cast<int32_t*>(lengths),
      static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// stream u16 [batch][cap], rows u8 or i32 [batch][n], blob: the table blob
// (table_bytes, a multiple of 16, 16-byte aligned; f|c at fc_words, buckets
// at bucket_words), values i32 [batch][n], ok u8 [batch]. cap >= 2 * lanes
// (the head). on_chip picks the variant; it needs kDecFixedSmem +
// table_bytes <= kMaxSmem.
int tpc_rans_decode(const void* stream_words, long long cap, const void* rows,
                    int rows_u8, const void* blob, int table_bytes, int fc_words,
                    int bucket_words, int num_rows, int precision, int bucket_bits,
                    int on_chip, int batch, long long n, int lanes, void* values,
                    void* ok, void* stream) {
  if (bad_args(num_rows, precision, bucket_bits, batch, n, lanes) ||
      cap < 2LL * lanes || bad_blob(blob, table_bytes) ||
      (on_chip && kDecFixedSmem + table_bytes > kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* words = static_cast<const uint16_t*>(stream_words);
  const auto* b32 = static_cast<const uint32_t*>(blob);
  const Blob tb{static_cast<const int4*>(blob), b32 + fc_words,
                reinterpret_cast<const uint16_t*>(b32 + bucket_words), num_rows,
                precision, bucket_bits};
  const auto* r = static_cast<const unsigned char*>(rows);
  const int row_bytes = rows_u8 ? 1 : 4;
  auto s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<int32_t*>(values);
  auto* okp = static_cast<uint8_t*>(ok);
  const int smem = kDecFixedSmem + (on_chip ? table_bytes : 0);
  // One lane a thread in 4 warps up to 128 lanes, in 16 up to 512; past
  // that, two a thread in 16 warps.
  cudaError_t err;
#define TPC_DECODE(NW, LPT)                                                    \
  (on_chip ? launch_decode<NW, LPT, true>(batch, smem, s, words, cap, r, row_bytes, tb, \
                                          table_bytes, fc_words, bucket_words, n, lanes, \
                                          v, okp)                                        \
           : launch_decode<NW, LPT, false>(batch, smem, s, words, cap, r, row_bytes, tb, \
                                           table_bytes, fc_words, bucket_words, n, lanes,\
                                           v, okp))
  if (lanes <= 4 * kWarp) {
    err = TPC_DECODE(4, 1);
  } else if (lanes <= kMaxDecWarps * kWarp) {
    err = TPC_DECODE(kMaxDecWarps, 1);
  } else {
    err = TPC_DECODE(kMaxDecWarps, 2);
  }
#undef TPC_DECODE
  return static_cast<int>(err);
}

const char* tpc_rans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
