// Interleaved-rANS byte coder for Hopper (sm_90a): encode, v1 decode, v0 decode.
//
// A shard's flat int8 payload is laid out as (T, 128) rows whose 128 columns
// are independent rANS lanes (lane l owns bytes l, 128 + l, ...); 32-bit
// states, 16-bit renormalisation, 12-bit frequency tables that sum to 4096.
// One CTA of 128 threads codes one shard, one thread per lane, so a lane's
// state lives in a register for the whole shard.  The three kernels share
// one core below: the table builds (build_freq_table, the decode table and
// slot_to_symbol of src/repro/kernels/entropy/rans.py) and the encode and
// decode steps.  They compute what the Pallas bodies compute, not their
// schedule: rows_per_step, the dot/swar histogram and the three division
// strategies are TPU and CPU schedule choices that give the same bits.
//
// What bounds them.  Each lane runs T dependent steps (T = 8192 for a 1 MiB
// shard), so a launch of S CTAs is S * 128 threads, one CTA per SM: the
// kernels are bound by the latency of that serial chain, far above both the
// bytes they move and the operations they do (PERF.md works out the numbers).
// The designs keep the chain short: tables in shared memory (one lookup per
// decode step), the encode's symbols loaded a batch of 8 rows ahead and its
// step free of branches, the v1 stream staged through a shared-memory ring.
// Spreading more shards per launch, or more lanes per shard (a wider
// interleave changes the stream format), is what would fill the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;              // one thread per rANS lane
constexpr int kWarps = kLanes / 32;
constexpr uint32_t kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kSymMask = 0x1FFF;    // 13 bits: freq and cum both reach 4096
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowBatch = 8;             // encode rows whose symbols load together
constexpr int kRing = 4096;              // v1 decode: stream words staged in shared memory
constexpr int kRefill = 1024;            // words per refill of the ring

// ----------------------------------------------------------- block helpers
// Each takes one value per thread of the 128-thread CTA; `red` holds kWarps
// entries of shared scratch.  The first __syncthreads keeps a call from
// overwriting `red` while a slow thread still reads the previous call's.

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return red[0] + red[1] + red[2] + red[3];
}

__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return max(max(red[0], red[1]), max(red[2], red[3]));
}

// Exclusive prefix (sum, or max with identity 0) over the threads in order,
// wrapping at 32 bits like the reference's int32 cumsum.
template <bool kMax>
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t v, uint32_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = kMax ? max(inc, n) : inc + n;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before = kMax ? max(before, red[w]) : before + red[w];
  const uint32_t excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) return before;
  return kMax ? max(before, excl) : before + excl;
}

// ------------------------------------------------------------ table builds
// build_freq_table (rans.py:154) in int32, thread l owning symbols 2l and
// 2l+1 with counts c0, c1: shift the counts until their total is below 2^19,
// reserve one slot per present symbol, floor-allocate the rest in proportion
// and give the remainder to the FIRST most frequent symbol (argmax).  Writes
// freq and the exclusive cumulative table.  The datapath caps a shard at
// 2^24 bytes, so every product below stays under 2^31.
__device__ void build_freq_table(int c0, int c1, int* freq, int* cum, uint32_t* red) {
  const int l = threadIdx.x;
  const int p0 = c0 > 0, p1 = c1 > 0;
  const int total = (int)block_sum(c0 + c1, red);
  const int n_present = (int)block_sum(p0 + p1, red);
  int shift = 0;
  for (int k = 0; k < 12; ++k) shift += total >= (1 << (19 + k));
  const int d0 = max(c0 >> shift, p0), d1 = max(c1 >> shift, p1);
  const int n2 = max((int)block_sum(d0 + d1, red), 1);
  const int budget = (int)kProbScale - n_present;
  const int e0 = d0 * budget / n2, e1 = d1 * budget / n2;
  const int rem = budget - (int)block_sum(e0 + e1, red);
  // argmax, first index on ties: the largest (count << 9 | 511 - symbol)
  const uint32_t key = max(((uint32_t)d0 << 9) | (511u - 2 * l),
                           ((uint32_t)d1 << 9) | (510u - 2 * l));
  const int top = 511 - (int)(block_max(key, red) & 511u);
  const int f0 = p0 + e0 + (top == 2 * l ? rem : 0);
  const int f1 = p1 + e1 + (top == 2 * l + 1 ? rem : 0);
  const int before = (int)block_excl_scan<false>(f0 + f1, red);
  freq[2 * l] = f0;
  freq[2 * l + 1] = f1;
  cum[2 * l] = before;
  cum[2 * l + 1] = before + f0;
  __syncthreads();
}

// The decode table of one shard from its 256 header frequencies (u16
// values), one entry per slot of the state's low 12 bits: the symbol, and
// f and slot - cum as the step uses them.  It composes the reference's two
// tables, slot_to_symbol (each present symbol marks its start slot, then a
// running max floods it over its bucket) and build_dec_table (p = f | cum <<
// 13 in u32, read back as p & 0x1FFF and (p >> 13) & 0x1FFF), so a step
// makes one shared-memory lookup instead of two dependent ones.  Present
// symbols have strictly increasing start slots, so no two marks collide and
// no atomics are needed; a zero-frequency symbol marks nothing.
__device__ void build_dec_table(const int32_t* freq, uint2* table, uint8_t* slot2sym,
                                uint32_t* dec, uint32_t* red) {
  const int l = threadIdx.x;
  const uint32_t f0 = (uint32_t)freq[2 * l], f1 = (uint32_t)freq[2 * l + 1];
  const uint32_t c0 = block_excl_scan<false>(f0 + f1, red), c1 = c0 + f0;
  dec[2 * l] = f0 | (c0 << 13);
  dec[2 * l + 1] = f1 | (c1 << 13);
  for (int i = l; i < (int)kProbScale; i += kLanes) slot2sym[i] = 0;
  __syncthreads();
  if (f0 > 0 && c0 < kProbScale) slot2sym[c0] = (uint8_t)(2 * l);
  if (f1 > 0 && c1 < kProbScale) slot2sym[c1] = (uint8_t)(2 * l + 1);
  __syncthreads();
  // running max: thread l owns slots [32 l, 32 l + 32)
  constexpr int kChunk = kProbScale / kLanes;
  const int first = kChunk * l;
  uint32_t run = 0;
  for (int j = 0; j < kChunk; ++j) run = max(run, (uint32_t)slot2sym[first + j]);
  run = block_excl_scan<true>(run, red);
  for (int j = 0; j < kChunk; ++j) {
    const uint32_t slot = first + j;
    run = max(run, (uint32_t)slot2sym[slot]);
    const uint32_t p = dec[run];
    table[slot] = make_uint2((p & kSymMask) | (run << 13), slot - ((p >> 13) & kSymMask));
  }
  __syncthreads();
}

// ------------------------------------------------------------------- steps
// _enc_step (rans.py:355), the hardware-divide strategy: renormalise when
// x >= f << 20 (written as a shift-compare so f = 4096 cannot overflow), then
// x' = x + (x / f) * (4096 - f) + cum in wrapping u32.  e = f | cum << 16.
__device__ __forceinline__ uint32_t enc_step(uint32_t x, uint32_t e, bool* emit) {
  const uint32_t f = e & 0xFFFFu;
  *emit = (x >> 20) >= f;
  if (*emit) x >>= 16;
  return x + (x / f) * (kProbScale - f) + (e >> 16);
}

// _dec_step (rans.py:410): symbol of the state's low 12 bits and the state
// before renormalisation, x' = f * (x >> 12) + slot - cum in wrapping u32.
__device__ __forceinline__ uint32_t dec_step(uint32_t x, const uint2* table, uint32_t* sym) {
  const uint2 e = table[x & (kProbScale - 1)];
  *sym = e.x >> 13;
  return (e.x & kSymMask) * (x >> kProbBits) + e.y;
}

__device__ __forceinline__ int8_t out_byte(uint32_t sym, bool valid) {
  return valid ? (int8_t)((int)sym - (int)((sym & 0x80u) << 1)) : (int8_t)0;
}

__device__ __forceinline__ int clamp_valid(int32_t nv, int T) {
  return min(max(nv, 0), T * kLanes);
}

// --------------------------------------------------------------------- B7
// Replaces _encode_kernel (src/repro/kernels/entropy/rans.py:533), the
// standalone encode of the chained write: per shard a histogram of the valid
// bytes, the frequency table, then each lane encodes its rows in reverse.
// The Pallas body counted the zero padding too and took it back out of bin
// 0; shared-memory atomics over the valid bytes alone give the same counts
// in any order.  At every position the word is the low 16 bits of the state
// before the step and the mask says whether the step emitted it (past
// n_valid the state is frozen and emits nothing), so the dense outputs equal
// the reference's in full; ops.py compacts them into the stream.
__global__ void __launch_bounds__(kLanes)
rans_encode_kernel(const int8_t* __restrict__ codes, const int32_t* __restrict__ n_valid,
                   int T, uint16_t* __restrict__ words, uint8_t* __restrict__ mask,
                   int32_t* __restrict__ freq_out, uint32_t* __restrict__ states) {
  __shared__ int hist[256];
  __shared__ int freq[256];
  __shared__ int cum[256];
  __shared__ uint32_t enc[256];
  __shared__ uint32_t red[kWarps];
  const int s = blockIdx.x, l = threadIdx.x;
  const size_t n_pos = (size_t)T * kLanes;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(codes) + s * n_pos;
  const int nv = clamp_valid(n_valid[s], T);

  hist[l] = 0;
  hist[l + kLanes] = 0;
  __syncthreads();
  const uint4* src16 = reinterpret_cast<const uint4*>(src);
  for (int i = l; i < nv / 16; i += kLanes) {
    const uint4 v = src16[i];
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 32; b += 8) atomicAdd(&hist[(w4[j] >> b) & 0xFFu], 1);
    }
  }
  for (int i = (nv / 16) * 16 + l; i < nv; i += kLanes) atomicAdd(&hist[src[i]], 1);
  __syncthreads();

  build_freq_table(hist[2 * l], hist[2 * l + 1], freq, cum, red);
  for (int sym = l; sym < 256; sym += kLanes) {
    enc[sym] = (uint32_t)max(freq[sym], 1) | ((uint32_t)cum[sym] << 16);
    freq_out[s * 256 + sym] = freq[sym];
  }
  __syncthreads();

  uint16_t* w_out = words + s * n_pos;
  uint8_t* m_out = mask + s * n_pos;
  uint32_t x = kRansL;
  // the symbols of the next batch of rows load while this batch codes, so
  // the loads stay off the state's dependency chain (padding is read but not
  // used)
  uint32_t next[kRowBatch];
#pragma unroll
  for (int j = 0; j < kRowBatch; ++j) next[j] = src[(T - 1 - j) * kLanes + l];
  for (int t0 = T - 1; t0 >= 0; t0 -= kRowBatch) {  // T is a multiple of 8
    uint32_t sym[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      sym[j] = next[j];
      if (t0 >= kRowBatch) next[j] = src[(t0 - kRowBatch - j) * kLanes + l];
    }
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      // past n_valid the entry is the identity sentinel (f = 4096, cum = 0):
      // (x >> 20) >= 4096 never holds for a 32-bit state and x' = x, so the
      // step needs no branch and the symbol-only half of the divide can run
      // ahead of the state's chain
      const int pos = (t0 - j) * kLanes + l;
      bool emit;
      const uint32_t x_next = enc_step(x, pos < nv ? enc[sym[j]] : kProbScale, &emit);
      w_out[pos] = (uint16_t)x;
      m_out[pos] = emit;
      x = x_next;
    }
  }
  states[s * kLanes + l] = x;
}

// --------------------------------------------------------------------- B3
// Replaces _decode_kernel (src/repro/kernels/entropy/rans.py:548), the
// version-1 decode of every rANS restore.  Words lie in row-major
// decoder-read order behind one per-shard pointer: in each row the lanes
// that need a word take the next ones in lane order.  The Pallas body took
// that order from a cumsum over the lane axis; here a warp's ballot and
// popcount give each lane its rank, and the four warp totals go through
// shared memory, double-buffered so one __syncthreads per row is enough.
// Reads past the end clamp to word W - 1, as in the reference.  The words
// reach the lanes through a ring in shared memory, refilled 1024 words at a
// time (8 independent loads a thread) whenever fewer than 1152 remain ahead
// of the pointer, so a row waits on device memory once per refill instead of
// once per row.
__global__ void __launch_bounds__(kLanes)
rans_decode_kernel(const uint16_t* __restrict__ stream, int W,
                   const int32_t* __restrict__ freq, const uint32_t* __restrict__ states,
                   const int32_t* __restrict__ n_valid, int T, int8_t* __restrict__ out) {
  __shared__ uint2 table[kProbScale];
  __shared__ uint8_t slot2sym[kProbScale];
  __shared__ uint32_t dec[256];
  __shared__ uint16_t ring[kRing];
  __shared__ uint32_t red[kWarps];
  __shared__ int totals[2][kWarps];
  const int s = blockIdx.x, l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const size_t n_pos = (size_t)T * kLanes;
  const int nv = clamp_valid(n_valid[s], T);
  const uint16_t* src = stream + (size_t)s * W;
  int8_t* dst = out + s * n_pos;
  build_dec_table(freq + s * 256, table, slot2sym, dec, red);

  // ring[i % kRing] holds word min(i, W - 1) for i in [filled - kRing, filled);
  // the rows read [base, base + 128), and refills keep base + 1152 <= filled
  // <= base + 2176, so no refill overwrites a word a row may still read
  long long filled = 0;
  auto refill = [&]() {
    uint16_t w[kRefill / kLanes];
#pragma unroll
    for (int j = 0; j < kRefill / kLanes; ++j)
      w[j] = src[min(filled + j * kLanes + l, (long long)W - 1)];
#pragma unroll
    for (int j = 0; j < kRefill / kLanes; ++j)
      ring[(filled + j * kLanes + l) & (kRing - 1)] = w[j];
    filled += kRefill;
  };
  refill();
  refill();
  __syncthreads();

  uint32_t x = states[s * kLanes + l];
  long long base = 0;
  for (int t = 0; t < T; ++t) {
    if (filled - base < kRefill + kLanes) {  // the same for every thread
      refill();
      __syncthreads();
    }
    const int pos = t * kLanes + l;
    const bool valid = pos < nv;
    uint32_t sym;
    uint32_t x2 = dec_step(x, table, &sym);
    const bool need = valid && x2 < kRansL;
    const unsigned ballot = __ballot_sync(kFull, need);
    if (lane == 0) totals[t & 1][warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u)), row = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = totals[t & 1][w];
      before += w < warp ? n : 0;
      row += n;
    }
    if (need) x2 = (x2 << 16) | ring[(base + before) & (kRing - 1)];
    if (valid) x = x2;
    base += row;
    dst[pos] = out_byte(sym, valid);
  }
}

// --------------------------------------------------------------------- B6
// Replaces _decode_kernel_v0 (src/repro/kernels/entropy/rans.py:598), the
// version-0 decode of older archives: lane l's words are one contiguous run
// starting at the exclusive prefix of the header's lane lengths, read
// through one pointer per lane.  The kernel reads the flat stream at
// off(l) + ptr instead of the reference's (T, 128) re-gather, keeping its
// clamps: ptr <= T - 1 and index in [0, W - 1].
__global__ void __launch_bounds__(kLanes)
rans_decode_v0_kernel(const uint16_t* __restrict__ stream, int W,
                      const int32_t* __restrict__ lane_lens, const int32_t* __restrict__ freq,
                      const uint32_t* __restrict__ states, const int32_t* __restrict__ n_valid,
                      int T, int8_t* __restrict__ out) {
  __shared__ uint2 table[kProbScale];
  __shared__ uint8_t slot2sym[kProbScale];
  __shared__ uint32_t dec[256];
  __shared__ uint32_t red[kWarps];
  const int s = blockIdx.x, l = threadIdx.x;
  const size_t n_pos = (size_t)T * kLanes;
  const int nv = clamp_valid(n_valid[s], T);
  const uint16_t* src = stream + (size_t)s * W;
  int8_t* dst = out + s * n_pos;
  build_dec_table(freq + s * 256, table, slot2sym, dec, red);
  const long long off =
      (int32_t)block_excl_scan<false>((uint32_t)lane_lens[s * kLanes + l], red);

  uint32_t x = states[s * kLanes + l];
  int ptr = 0;
  for (int t = 0; t < T; ++t) {
    const int pos = t * kLanes + l;
    const bool valid = pos < nv;
    uint32_t sym;
    uint32_t x2 = dec_step(x, table, &sym);
    if (valid && x2 < kRansL) {
      const long long idx = off + min(ptr, T - 1);
      x2 = (x2 << 16) | src[idx < 0 ? 0 : (idx > W - 1 ? W - 1 : idx)];
      ++ptr;
    }
    if (valid) x = x2;
    dst[pos] = out_byte(sym, valid);
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError().
int rans_encode_launch(const void* codes, const void* n_valid, int S, int T, void* words,
                       void* mask, void* freq, void* states, void* stream) {
  if (S > 0) {
    rans_encode_kernel<<<S, kLanes, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, (const int32_t*)n_valid, T, (uint16_t*)words,
        (uint8_t*)mask, (int32_t*)freq, (uint32_t*)states);
  }
  return (int)cudaGetLastError();
}

int rans_decode_launch(const void* words, int W, const void* freq, const void* states,
                       const void* n_valid, int S, int T, void* out, void* stream) {
  if (S > 0) {
    rans_decode_kernel<<<S, kLanes, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)words, W, (const int32_t*)freq, (const uint32_t*)states,
        (const int32_t*)n_valid, T, (int8_t*)out);
  }
  return (int)cudaGetLastError();
}

int rans_decode_v0_launch(const void* words, int W, const void* lane_lens, const void* freq,
                          const void* states, const void* n_valid, int S, int T, void* out,
                          void* stream) {
  if (S > 0) {
    rans_decode_v0_kernel<<<S, kLanes, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)words, W, (const int32_t*)lane_lens, (const int32_t*)freq,
        (const uint32_t*)states, (const int32_t*)n_valid, T, (int8_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
