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
// chains may run in passes of G (chains_meet), each pass expanding the
// schedule anew; or the schedule may be expanded once into a shared-memory
// plane and read back by every pass (stage_schedule, staged_pass). The
// same arithmetic as ops/sha256_torch.py, whose plain versions the kernels
// are held against. Rounds are unrolled at compile time, so the 16-word
// schedule window and the round constants are register and constant-bank
// operands, and every rotate is one funnel shift.
//
// Compile forms, the counterparts of the JAX kernels' `unroll` and `spec`
// (bitcoin_miner_tpu/ops/sha256_pallas.py:210-224, :247, :296-333):
//   -DUNROLL=U  U < 64: the round loops stay rolled, unrolled U times (the
//               lax.scan round body). The 16-word schedule window rotates
//               through registers (advance) rather than being indexed as
//               w[i & 15], which would push it into local memory, and each
//               round reads K[i] from constant memory at an index that is
//               the same in every lane of a warp.
//   -DSPEC=0    no partial evaluation: the padding, length and IV words are
//               read at run time from constant memory (kRunWords) instead
//               of being literals, so nothing that depends on them folds.
// As in the JAX kernels, spec applies only to the unrolled form: a rolled
// form reads those words at run time too. Every form computes the same
// function.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef UNROLL
#define UNROLL 64
#endif
#ifndef SPEC
#define SPEC 1
#endif

namespace sha256d {

constexpr int kUnroll = UNROLL;
constexpr bool kRolled = UNROLL < 64;
constexpr bool kSpec = SPEC && !kRolled;
static_assert(UNROLL >= 1, "UNROLL >= 1");

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

// The words a spec form folds, for the forms that read them at run time:
// [0, 16) chunk 2's message words by index (4..15 used: the padding and the
// 640-bit length), [16, 32) the digest's message words by index (8..15
// used: the padding and 256), [32, 40) the IV.
__constant__ uint32_t kRunWords[40] = {
    0u, 0u, 0u, 0u, 0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 640u,
    0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 256u,
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, 0x510E527Fu,
    0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

// Chunk 2's message word i (4 <= i < 16) of an 80-byte header.
__device__ __forceinline__ uint32_t chunk2_word(int i) {
  if constexpr (kSpec) return i == 4 ? 0x80000000u : i == 15 ? 640u : 0u;
  return kRunWords[i & 15];
}

// The digest's message word i (8 <= i < 16) of a 32-byte message.
__device__ __forceinline__ uint32_t digest_word(int i) {
  if constexpr (kSpec) return i == 8 ? 0x80000000u : i == 15 ? 256u : 0u;
  return kRunWords[16 + (i & 15)];
}

// IV word i, a literal in the spec form.
__device__ __forceinline__ uint32_t iv_word(int i) {
  if constexpr (kSpec) return iv(i);
  return kRunWords[32 + (i & 7)];
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

// Rolled forms: `w` holds message words w[i..i+15]; shift it to
// w[i+1..i+16], expanding w[i+16] when `expand` (i + 16 < 64).
__device__ __forceinline__ void advance(uint32_t (&w)[16], bool expand) {
  const uint32_t next =
      expand ? w[0] + small_sigma0(w[1]) + w[9] + small_sigma1(w[14]) : 0u;
#pragma unroll
  for (int j = 0; j < 15; ++j) w[j] = w[j + 1];
  w[15] = next;
}

// rounds<START, END> in the rolled form, from a window holding w[0..15]:
// the window is first advanced to w[START..], then each round reads w[0].
template <int START, int END>
__device__ __forceinline__ void rounds_rolled(uint32_t (&s)[8],
                                              uint32_t (&w)[16]) {
#pragma unroll
  for (int i = 0; i < START; ++i) advance(w, true);
#pragma unroll(kUnroll)
  for (int i = START; i < END; ++i) {
    sha_round(s, i, w[0]);
    advance(w, i + 16 < 64);
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

// hash <= target over the byte-reversed digest's 8 limbs (job words at..at+7,
// most significant first), built from the least significant limb up as in
// ops/sha256_torch.py::meets_target_words.
template <class Job>
__device__ __forceinline__ bool meets_target(const uint32_t (&h2)[8],
                                             const Job& job, int at) {
  bool le = bswap32(h2[0]) <= job[at + 7];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const uint32_t d = bswap32(h2[k]);
    const uint32_t t = job[at + 7 - k];
    le = (d < t) || ((d == t) && le);
  }
  return le;
}

// The chunk-2 message window of one nonce: header[64:76], the nonce, and
// the padding of an 80-byte message.
template <int K, class Job>
__device__ __forceinline__ void window(const Job& job, uint32_t nonce,
                                       uint32_t (&w)[16]) {
  using L = Layout<K>;
  w[0] = job[L::kTail];
  w[1] = job[L::kTail + 1];
  w[2] = job[L::kTail + 2];
  w[3] = bswap32(nonce);
#pragma unroll
  for (int i = 4; i < 16; ++i) w[i] = chunk2_word(i);
}

// Rounds [START, END) of the chunk-2 compressions of I nonces, nonce v on
// its own window w[v] and on G register states s[v][0..G): each schedule
// word is expanded once per nonce and fed to all G states. In a rolled
// form each window rotates as in rounds_rolled.
template <int G, int I, int START, int END>
__device__ __forceinline__ void rounds_shared(uint32_t (&s)[I][G][8],
                                              uint32_t (&w)[I][16]) {
  if constexpr (kRolled) {
#pragma unroll
    for (int i = 0; i < START; ++i) {
#pragma unroll
      for (int v = 0; v < I; ++v) advance(w[v], true);
    }
#pragma unroll(kUnroll)
    for (int i = START; i < END; ++i) {
#pragma unroll
      for (int v = 0; v < I; ++v) {
#pragma unroll
        for (int g = 0; g < G; ++g) sha_round(s[v][g], i, w[v][0]);
        advance(w[v], i + 16 < 64);
      }
    }
  } else {
#pragma unroll
    for (int i = START; i < END; ++i) {
#pragma unroll
      for (int v = 0; v < I; ++v) {
        if (i >= 16) w[v][i & 15] = schedule(w[v], i);
#pragma unroll
        for (int g = 0; g < G; ++g) sha_round(s[v][g], i, w[v][i & 15]);
      }
    }
  }
}

// Chain c's verdict from its registers s after round 63 of chunk 2: the
// feedforward of its midstate, then the compression of the 32-byte digest.
// With WORD7 the candidate test bswap32(h2[7]) <= limbs[0] (a superset of
// the hits, re-verified by the host), which stops after round 60's t1;
// otherwise hash <= target.
template <int K, bool WORD7, class Job>
__device__ __forceinline__ bool second_meets(const Job& job, int c,
                                             const uint32_t (&s)[8]) {
  using L = Layout<K>;
  uint32_t w2[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) w2[i] = s[i] + job[L::kMid + 8 * c + i];
#pragma unroll
  for (int i = 8; i < 16; ++i) w2[i] = digest_word(i);
  uint32_t t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = iv_word(i);
  if (WORD7) {
    uint32_t w60;
    if constexpr (kRolled) {
      rounds_rolled<0, 60>(t, w2);
      w60 = w2[0];
    } else {
      rounds<0, 60>(t, w2);
      w60 = schedule(w2, 60);
    }
    const uint32_t t1 =
        t[7] + big_sigma1(t[4]) + ch(t[4], t[5], t[6]) + kK[60] + w60;
    return bswap32(iv_word(7) + t[3] + t1) <= job[L::kLimbs];
  }
  if constexpr (kRolled) {
    rounds_rolled<0, 64>(t, w2);
  } else {
    rounds<0, 64>(t, w2);
  }
  uint32_t h2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h2[i] = t[i] + iv_word(i);
  return meets_target(h2, job, L::kLimbs);
}

// The verdicts of K chains for I nonces (meets[v][c]), the chains in passes
// of G over the rounds (the cgroup axis), from chain C0 on: each pass sets
// up every nonce's window anew, expands its schedule in registers and feeds
// it to the pass's chains, then runs their second compressions. A pass
// alone holds I x (8G + 16) words across the rounds, not I x (8K + 16);
// but passes, like the I nonces, are independent dataflow that the
// scheduler may overlap, so the register count stays the compiler's
// choice. G = K, I = 1 is the one-pass form of the baseline. The passes
// recurse at compile time, since a loop over them could exceed what the
// compiler unrolls and leave the chains' arrays in local memory. `job`
// holds the constants of K chains (Layout<K>), read where each is used:
// through a pointer, a load the compiler may hold or repeat; from launch
// parameters, a constant-bank operand.
template <int K, int G, int I, bool WORD7, int C0 = 0, class Job>
__device__ __forceinline__ void chains_meet(const Job& job,
                                            const uint32_t (&nonce)[I],
                                            bool (&meets)[I][K]) {
  if constexpr (C0 < K) {
    using L = Layout<K>;
    constexpr int N = K - C0 < G ? K - C0 : G;  // chains of this pass
    uint32_t w[I][16];
#pragma unroll
    for (int v = 0; v < I; ++v) window<K>(job, nonce[v], w[v]);
    uint32_t s[I][N][8];
#pragma unroll
    for (int v = 0; v < I; ++v) {
#pragma unroll
      for (int g = 0; g < N; ++g) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[v][g][i] = job[L::kState3 + 8 * (C0 + g) + i];
        }
      }
    }
    rounds_shared<N, I, 3, 64>(s, w);
#pragma unroll
    for (int g = 0; g < N; ++g) {
#pragma unroll
      for (int v = 0; v < I; ++v) {
        meets[v][C0 + g] = second_meets<K, WORD7>(job, C0 + g, s[v][g]);
      }
    }
    chains_meet<K, G, I, WORD7, C0 + G>(job, nonce, meets);
  }
}

// The verdicts of K chains for one nonce, all chains in one pass.
template <int K, bool WORD7>
__device__ __forceinline__ void nonce_meets(const uint32_t* __restrict__ job,
                                            uint32_t nonce, bool (&meets)[K]) {
  const uint32_t nonces[1] = {nonce};
  bool m[1][K];
  chains_meet<K, K, 1, WORD7>(job, nonces, m);
#pragma unroll
  for (int c = 0; c < K; ++c) meets[c] = m[0][c];
}

// Staged tile, phase 1: one nonce's chunk-2 schedule words W[16..63],
// expanded in its window and stored to the thread's column of a plane of T
// threads, col[(t - 16) * T], so that a warp stores 32 consecutive words.
template <int K, int T, class Job>
__device__ __forceinline__ void stage_schedule(const Job& job, uint32_t nonce,
                                               uint32_t* col) {
  uint32_t w[16];
  window<K>(job, nonce, w);
#pragma unroll
  for (int i = 16; i < 64; ++i) {
    w[i & 15] = schedule(w, i);
    col[(i - 16) * T] = w[i & 15];
  }
}

// Staged tile, phase 2: chains [C0, C0 + N) of one nonce over chunk-2
// rounds 3-63 from their round-3 states. Message word 3 is the nonce's,
// words 4-15 the padding, and words 16-63 are loaded back from the thread's
// column of the plane, each once per pass and fed to the pass's chains: no
// schedule window lives across the rounds. Then each chain's second
// compression.
template <int K, int C0, int N, int T, bool WORD7, class Job>
__device__ __forceinline__ void staged_pass(const Job& job, uint32_t nonce,
                                            const uint32_t* col,
                                            bool (&meets)[N]) {
  using L = Layout<K>;
  uint32_t s[N][8];
#pragma unroll
  for (int g = 0; g < N; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[g][i] = job[L::kState3 + 8 * (C0 + g) + i];
  }
  const uint32_t w3 = bswap32(nonce);
#if UNROLL >= 64
#pragma unroll
#else
#pragma unroll(kUnroll)
#endif
  for (int i = 3; i < 64; ++i) {
    const uint32_t wi = i >= 16 ? col[(i - 16) * T]
                        : i == 3 ? w3
                                 : chunk2_word(i);
#pragma unroll
    for (int g = 0; g < N; ++g) sha_round(s[g], i, wi);
  }
#pragma unroll
  for (int g = 0; g < N; ++g) {
    meets[g] = second_meets<K, WORD7>(job, C0 + g, s[g]);
  }
}

}  // namespace sha256d
