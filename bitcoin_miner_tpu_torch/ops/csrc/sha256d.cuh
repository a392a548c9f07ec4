// SHA-256d round math for the scan kernels (sm_90a), shared by
// scan_tile.cu and scan_hitbuf.cu.
//
// Per nonce: the chunk-2 compression resumes at round 3 from the job's
// round-3 state (rounds 0-2 read only header[64:76]), with the midstate
// as feed-forward; then one compression of the 32-byte digest. The same
// arithmetic as ops/sha256_torch.py, whose plain versions the kernels are
// held against. Rounds are unrolled at compile time, so the 16-word
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

// The per-job constants of one scan, in registers.
struct Job {
  uint32_t mid[8];    // chunk-1 midstate: chunk-2 feed-forward
  uint32_t s3[8];     // registers after chunk-2 rounds 0-2
  uint32_t tail[3];   // header[64:76] as big-endian words
  uint32_t limbs[8];  // target, big-endian limbs, most significant first
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
template <int I>
__device__ __forceinline__ uint32_t schedule(const uint32_t (&w)[16]) {
  return w[I & 15] + small_sigma0(w[(I - 15) & 15]) + w[(I - 7) & 15] +
         small_sigma1(w[(I - 2) & 15]);
}

// Rounds [START, END) on registers s = (a..h), expanding the schedule in
// place once past round 15.
template <int START, int END>
__device__ __forceinline__ void rounds(uint32_t (&s)[8], uint32_t (&w)[16]) {
#pragma unroll
  for (int i = START; i < END; ++i) {
    if (i >= 16) {
      w[i & 15] = w[i & 15] + small_sigma0(w[(i - 15) & 15]) +
                  w[(i - 7) & 15] + small_sigma1(w[(i - 2) & 15]);
    }
    const uint32_t t1 =
        s[7] + big_sigma1(s[4]) + ch(s[4], s[5], s[6]) + kK[i] + w[i & 15];
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
}

// Registers after rounds 0-2 of chunk 2 from the midstate and header tail
// (the job constant the tile kernel's job block carries precomputed).
__device__ __forceinline__ void state3(Job& j) {
  uint32_t w[16] = {j.tail[0], j.tail[1], j.tail[2]};
#pragma unroll
  for (int i = 0; i < 8; ++i) j.s3[i] = j.mid[i];
  rounds<0, 3>(j.s3, w);
}

// hash <= target over the byte-reversed digest's 8 limbs, built from the
// least significant limb up as in ops/sha256_torch.py::meets_target_words.
__device__ __forceinline__ bool meets_target(const uint32_t (&h2)[8],
                                             const uint32_t (&limbs)[8]) {
  bool le = bswap32(h2[0]) <= limbs[7];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const uint32_t d = bswap32(h2[k]);
    const uint32_t t = limbs[7 - k];
    le = (d < t) || ((d == t) && le);
  }
  return le;
}

// The verdict for one nonce: hash <= target, or with WORD7 the candidate
// test bswap32(h2[7]) <= limbs[0] (a superset of the hits, re-verified by
// the host), which stops the second compression after round 60's t1.
template <bool WORD7>
__device__ __forceinline__ bool nonce_meets(const Job& j, uint32_t nonce) {
  uint32_t w[16];
  w[0] = j.tail[0];
  w[1] = j.tail[1];
  w[2] = j.tail[2];
  w[3] = bswap32(nonce);
  w[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) w[i] = 0u;
  w[15] = 640u;  // 80 bytes
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = j.s3[i];
  rounds<3, 64>(s, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = s[i] + j.mid[i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) w[i] = 0u;
  w[15] = 256u;  // 32 bytes
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = iv(i);
  if (WORD7) {
    rounds<0, 60>(s, w);
    const uint32_t t1 = s[7] + big_sigma1(s[4]) + ch(s[4], s[5], s[6]) +
                        kK[60] + schedule<60>(w);
    return bswap32(iv(7) + s[3] + t1) <= j.limbs[0];
  }
  rounds<0, 64>(s, w);
  uint32_t h2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h2[i] = s[i] + iv(i);
  return meets_target(h2, j.limbs);
}

}  // namespace sha256d
