// SHA-256d round math for the scan kernels (sm_90a), shared by
// scan_tile.cu and scan_hitbuf.cu.
//
// Per nonce: the chunk-2 compression resumes at round 3 from the job's
// round-3 state (rounds 0-2 read only header[64:76]), with the midstate
// as feed-forward; then one compression of the 32-byte digest. With K
// version-rolled chains (vshare, the overt-AsicBoost pattern) the K headers
// differ only in chunk 1, so their chunk-2 compressions read one message:
// each round's schedule word is expanded once per nonce and fed to K
// register states, then each chain runs its own second compression. The
// same arithmetic as ops/sha256_torch.py, whose plain versions the kernels
// are held against. Rounds are unrolled at compile time, so the 16-word
// schedule window and the round constants are register and constant-bank
// operands, and every rotate is one funnel shift.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sha256d {

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

// The IV as literals, so that the second compression's first rounds fold.
__device__ __forceinline__ constexpr uint32_t iv(int i) {
  return i == 0   ? 0x6A09E667u
         : i == 1 ? 0xBB67AE85u
         : i == 2 ? 0x3C6EF372u
         : i == 3 ? 0xA54FF53Au
         : i == 4 ? 0x510E527Fu
         : i == 5 ? 0x9B05688Cu
         : i == 6 ? 0x1F83D9ABu
                  : 0x5BE0CD19u;
}

// Word offsets of the per-job constants of K chains, the head of the tile
// kernel's job block: midstate x K | round3_state x K | tail3 | limbs.
template <int K>
struct Layout {
  static constexpr int kMid = 0;             // chunk-1 midstates: feed-forward
  static constexpr int kState3 = 8 * K;      // registers after rounds 0-2
  static constexpr int kTail = 16 * K;       // header[64:76], big-endian words
  static constexpr int kLimbs = 16 * K + 3;  // target, most significant first
  static constexpr int kWords = 16 * K + 11;
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
__device__ __forceinline__ uint32_t big_sigma0(uint32_t x) {
  return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22);
}
__device__ __forceinline__ uint32_t big_sigma1(uint32_t x) {
  return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25);
}
__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) {
  return g ^ (e & (f ^ g));
}
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return b ^ ((a ^ b) & (b ^ c));
}
__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// Message word i (i >= 16) from the rolling window w[i % 16].
__device__ __forceinline__ uint32_t schedule(const uint32_t (&w)[16], int i) {
  return w[i & 15] + small_sigma0(w[(i - 15) & 15]) + w[(i - 7) & 15] +
         small_sigma1(w[(i - 2) & 15]);
}

// Round i on registers s = (a..h) with message word wi.
__device__ __forceinline__ void sha_round(uint32_t (&s)[8], int i,
                                          uint32_t wi) {
  const uint32_t t1 =
      s[7] + big_sigma1(s[4]) + ch(s[4], s[5], s[6]) + kK[i] + wi;
  const uint32_t t2 = big_sigma0(s[0]) + maj(s[0], s[1], s[2]);
  s[7] = s[6];
  s[6] = s[5];
  s[5] = s[4];
  s[4] = s[3] + t1;
  s[3] = s[2];
  s[2] = s[1];
  s[1] = s[0];
  s[0] = t1 + t2;
}

// Rounds [START, END) on registers s = (a..h), expanding the schedule in
// place once past round 15.
template <int START, int END>
__device__ __forceinline__ void rounds(uint32_t (&s)[8], uint32_t (&w)[16]) {
#pragma unroll
  for (int i = START; i < END; ++i) {
    if (i >= 16) w[i & 15] = schedule(w, i);
    sha_round(s, i, w[i & 15]);
  }
}

// Rounds [START, END) of K compressions of one message, chain c on
// registers s[c]: each schedule word is expanded once and fed to all K.
template <int K, int START, int END>
__device__ __forceinline__ void rounds_shared(uint32_t (&s)[K][8],
                                              uint32_t (&w)[16]) {
#pragma unroll
  for (int i = START; i < END; ++i) {
    if (i >= 16) w[i & 15] = schedule(w, i);
#pragma unroll
    for (int c = 0; c < K; ++c) sha_round(s[c], i, w[i & 15]);
  }
}

// Registers after rounds 0-2 of chunk 2 from a midstate and the header
// tail: the round-3 state that the tile kernel's job block carries
// precomputed, and that scan_hitbuf.cu derives once per block.
__device__ __forceinline__ void state3(const uint32_t* mid,
                                       const uint32_t* tail, uint32_t* out) {
  uint32_t w[16] = {tail[0], tail[1], tail[2]};
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = mid[i];
  rounds<0, 3>(s, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = s[i];
}

// hash <= target over the byte-reversed digest's 8 limbs, built from the
// least significant limb up as in ops/sha256_torch.py::meets_target_words.
__device__ __forceinline__ bool meets_target(const uint32_t (&h2)[8],
                                             const uint32_t* limbs) {
  bool le = bswap32(h2[0]) <= limbs[7];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const uint32_t d = bswap32(h2[k]);
    const uint32_t t = limbs[7 - k];
    le = (d < t) || ((d == t) && le);
  }
  return le;
}

// The verdicts of K chains for one nonce: hash <= target, or with WORD7 the
// candidate test bswap32(h2[7]) <= limbs[0] (a superset of the hits,
// re-verified by the host), which stops the second compression after
// round 60's t1. `job` holds the constants of K chains (Layout<K>); each
// word is read where it is used, so at large K the compiler may reload a
// uniform word instead of holding 16K of them in registers.
template <int K, bool WORD7>
__device__ __forceinline__ void nonce_meets(const uint32_t* __restrict__ job,
                                            uint32_t nonce, bool (&meets)[K]) {
  using L = Layout<K>;
  uint32_t w[16];
  w[0] = job[L::kTail];
  w[1] = job[L::kTail + 1];
  w[2] = job[L::kTail + 2];
  w[3] = bswap32(nonce);
  w[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) w[i] = 0u;
  w[15] = 640u;  // 80 bytes
  uint32_t s[K][8];
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[c][i] = job[L::kState3 + 8 * c + i];
  }
  rounds_shared<K, 3, 64>(s, w);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    uint32_t w2[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) w2[i] = s[c][i] + job[L::kMid + 8 * c + i];
    w2[8] = 0x80000000u;
#pragma unroll
    for (int i = 9; i < 15; ++i) w2[i] = 0u;
    w2[15] = 256u;  // 32 bytes
    uint32_t t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = iv(i);
    if (WORD7) {
      rounds<0, 60>(t, w2);
      const uint32_t t1 = t[7] + big_sigma1(t[4]) + ch(t[4], t[5], t[6]) +
                          kK[60] + schedule(w2, 60);
      meets[c] = bswap32(iv(7) + t[3] + t1) <= job[L::kLimbs];
    } else {
      rounds<0, 64>(t, w2);
      uint32_t h2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h2[i] = t[i] + iv(i);
      meets[c] = meets_target(h2, job + L::kLimbs);
    }
  }
}

}  // namespace sha256d
