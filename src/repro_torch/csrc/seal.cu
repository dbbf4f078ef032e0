// Fused archival stripe kernel for Hopper (sm_90a): seal and unseal in one body.
//
// Replaces the TPU kernels in src/repro/kernels/seal/seal.py:
//   * _seal_kernel   (seal_stripe_pallas):   pack int8x4 -> LE u32, XOR the
//     ChaCha20 keystream, zero words >= n_valid, fold RAID P/Q over the
//     SEALED words;
//   * _unseal_kernel (unseal_stripe_pallas): XOR the keystream, zero words
//     >= n_valid, unpack LE u32 -> 4 signed int8, fold P/Q over the bodies
//     AS STORED (so a zero-key launch is the scrubber's parity recompute).
// Both Pallas bodies share _stripe_call; here one template with a mode flag
// plays that role.
//
// Mapping.  Word w of a shard is word w%16 of ChaCha20 block w/16 (counter0
// = 0), the mapping of seal.py::_keystream_tile.  One thread owns one
// 16-word block, so the keystream needs no cross-thread traffic.  The Pallas
// grid (tiles x shards) carried P/Q across the sequential shard axis in a
// revisited output block; Hopper runs blocks in no order, so instead each
// thread loops over the S shards itself and keeps the P/Q of its 16 words in
// registers: P and Q are written once, with no atomics and no second pass.
// On little-endian hardware "pack int8x4 -> LE u32" and "unpack LE u32 ->
// int8x4" are reinterpretations of the same 4 bytes, so the codes are moved
// as u32 words (16-byte vector loads and stores).
//
// Bound.  The kernel moves ~2 bytes of device memory per payload byte, but
// ChaCha20 costs ~15 int32 operations per byte and the SWAR GF(256) multiply
// of RAID-6 Q up to ~9 more, so it is bound by integer issue rate (132 SMs
// x 64 INT32 lanes x clock), not by HBM.  Rotates use __funnelshift_l (one
// SHF each), and the GF multiply walks only the set span of the per-shard
// coefficient g^s.  Ragged shards are padded to the longest, so a block
// wholly past its shard's n_valid skips the keystream: the seal stores zeros
// and folds nothing, the unseal stores zero codes and folds the stored words.  One thread per block gives R*8 threads per stripe, which
// leaves most of the card idle for short stripes; splitting shards across
// warps with a shared-memory P/Q reduce is the next step for speed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define QR(a, b, c, d)                 \
  a += b; d ^= a; d = rotl32(d, 16);   \
  c += d; b ^= c; b = rotl32(b, 12);   \
  a += b; d ^= a; d = rotl32(d, 8);    \
  c += d; b ^= c; b = rotl32(b, 7);

// RFC 8439 block function: 20 rounds + feed-forward.
__device__ __forceinline__ void chacha20_block(const uint32_t* key,
                                               const uint32_t* nonce,
                                               uint32_t counter,
                                               uint32_t out[16]) {
  uint32_t in[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                     key[0], key[1], key[2], key[3],
                     key[4], key[5], key[6], key[7],
                     counter, nonce[0], nonce[1], nonce[2]};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = in[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = x[i] + in[i];
}

// acc[i] ^= coef * x[i] in GF(256) (poly 0x11D), 4 bytes per word: peasant
// product with xtime in SWAR form, so no byte carries into the next.  The
// loop ends at coef's top set bit (bits above it add nothing, and no xtime
// follows it); coef is the same for every thread, so the branch does not
// diverge.
__device__ __forceinline__ void gf_mul_acc(uint32_t acc[16], const uint32_t src[16],
                                           uint32_t coef) {
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = src[i];
  while (coef) {
    if (coef & 1u) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] ^= x[i];
    }
    coef >>= 1;
    if (!coef) break;  // no xtime after the top set bit
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t hi = (x[i] >> 7) & 0x01010101u;
      x[i] = ((x[i] << 1) & 0xFEFEFEFEu) ^ (hi * 0x1Du);
    }
  }
}

__device__ __forceinline__ void load16(const uint32_t* src, uint32_t v[16]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 t = s[i];
    v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void store16(uint32_t* dst, const uint32_t v[16]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// in/out: (S, R, 128) words (int8 codes viewed as u32 on the codes side).
// keys (S, 8), nonces (S, 3), q_coef (S,) u32; n_valid (S,) i32.
// p/q: (R, 128) u32, written when with_p / with_q.
template <bool kSeal>
__global__ void __launch_bounds__(128)
stripe_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
              uint32_t* __restrict__ p_out, uint32_t* __restrict__ q_out,
              const uint32_t* __restrict__ keys,
              const uint32_t* __restrict__ nonces,
              const int32_t* __restrict__ n_valid,
              const uint32_t* __restrict__ q_coef,
              int S, int64_t blocks_per_shard, int with_p, int with_q) {
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (blk >= blocks_per_shard) return;
  const int64_t w0 = blk * 16;              // first word of this thread's block
  const int64_t shard_words = blocks_per_shard * 16;

  uint32_t p[16], q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) { p[i] = 0u; q[i] = 0u; }

  for (int s = 0; s < S; ++s) {
    const int64_t base = s * shard_words + w0;
    const int64_t nv = n_valid[s];
    const bool live = w0 < nv;  // the block holds at least one valid word
    uint32_t data[16], res[16];
    if (kSeal && !live) {
      // past the payload the sealed words are 0: no keystream, no input, no
      // parity to fold
#pragma unroll
      for (int i = 0; i < 16; ++i) res[i] = 0u;
      store16(out + base, res);
      continue;
    }
    load16(in + base, data);
    if (live) {
      uint32_t ks[16];
      chacha20_block(keys + 8 * s, nonces + 3 * s, static_cast<uint32_t>(blk), ks);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        res[i] = (w0 + i < nv) ? (data[i] ^ ks[i]) : 0u;
    } else {
      // unseal past the payload: codes are 0, parity still folds the stored
      // words (a scrub must see a flipped bit there)
#pragma unroll
      for (int i = 0; i < 16; ++i) res[i] = 0u;
    }
    store16(out + base, res);
    // parity over the sealed words: the seal's output, the unseal's input
    const uint32_t* sealed = kSeal ? res : data;
    if (with_p) {
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] ^= sealed[i];
    }
    if (with_q) gf_mul_acc(q, sealed, q_coef[s]);
  }
  if (with_p) store16(p_out + w0, p);
  if (with_q) store16(q_out + w0, q);
}

}  // namespace

// mode 1 = seal (in: int8 codes, out: sealed u32), 0 = unseal (in: sealed
// u32, out: int8 codes).  Every buffer is contiguous and 16-byte aligned; the
// caller checks.  Launches on `stream`; returns cudaGetLastError().
extern "C" int stripe_launch(int mode, const void* in, void* out, void* p,
                             void* q, const void* keys, const void* nonces,
                             const void* n_valid, const void* q_coef, int S,
                             int R, int with_p, int with_q, void* stream) {
  const int64_t blocks_per_shard = static_cast<int64_t>(R) * 8;  // 128 words/row
  if (S <= 0 || blocks_per_shard <= 0) return cudaGetLastError();
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((blocks_per_shard + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* in_w = static_cast<const uint32_t*>(in);
  auto* out_w = static_cast<uint32_t*>(out);
  auto* p_w = static_cast<uint32_t*>(p);
  auto* q_w = static_cast<uint32_t*>(q);
  auto* k_w = static_cast<const uint32_t*>(keys);
  auto* n_w = static_cast<const uint32_t*>(nonces);
  auto* v_w = static_cast<const int32_t*>(n_valid);
  auto* c_w = static_cast<const uint32_t*>(q_coef);
  if (mode) {
    stripe_kernel<true><<<grid, threads, 0, st>>>(in_w, out_w, p_w, q_w, k_w, n_w, v_w,
                                                  c_w, S, blocks_per_shard, with_p, with_q);
  } else {
    stripe_kernel<false><<<grid, threads, 0, st>>>(in_w, out_w, p_w, q_w, k_w, n_w, v_w,
                                                   c_w, S, blocks_per_shard, with_p, with_q);
  }
  return static_cast<int>(cudaGetLastError());
}
