// Native CPU SHA-256d hasher: the compiled counterpart of the hashlib
// oracle, the CPU benchmark path (`--backend native`) and the pool
// frontend's share validator. Host code: it runs on the CPU, never the card.
//
// Exposes a C ABI consumed via ctypes (backends/native.py, which builds it
// with g++ under build/native/):
//   btm_sha256d      — full double-SHA-256 of an arbitrary buffer
//   btm_midstate     — SHA-256 state after the first 64-byte header chunk
//   btm_scan         — the hot loop: midstate-cached sha256d over a nonce
//                      range with target compare (2 compressions per nonce)
//
// Two compression backends, chosen at load time by CPUID:
//   - SHA-NI (x86 SHA extensions) — ~hardware-speed rounds, on CPUs that
//     report sha_ni;
//   - scalar — fully unrolled rounds, the portable fallback.
// Both share midstate reuse and a second-hash message block that is
// constant except for the 8 digest words.
// Build: backends/native.py (baseline x86-64 flags, no -march=native — see
// the note at compress_shani_xn).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstddef>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#include <cpuid.h>
#define BTM_HAVE_X86 1
// Guard the no-wide-vectors invariant at the source level (a caller's
// flags could add -march=native): building this TU with AVX2/AVX-512
// codegen lets gcc mix 256/512-bit moves around the legacy-encoded SHA
// instructions, whose dirty-upper penalty is ~80x on AVX-512 CPUs. Define
// BTM_ALLOW_WIDE_VECTORS to override knowingly.
#if (defined(__AVX2__) || defined(__AVX512F__)) && \
    !defined(BTM_ALLOW_WIDE_VECTORS)
#error "Build without AVX2/AVX-512 (see the build note): wide-vector codegen \
puts legacy-encoded SHA instructions in the dirty-upper penalized state."
#endif
#endif

// SHA-NI is a TOOLCHAIN capability before it is a CPU one: some g++
// builds reject parts of the SHA surface (Debian's g++ 10 accepts the
// _mm_sha256* intrinsics and the "sha" target attribute but rejects
// __builtin_cpu_supports("sha") — which is why the runtime dispatch below
// reads CPUID leaf 7 directly instead of using the builtin). The loader
// compile-probes exactly the constructs this TU uses and defines
// BTM_NO_SHANI when any is absent, so the scalar path still builds and
// dispatch simply never has a SHA-NI candidate to pick.
#if defined(BTM_HAVE_X86) && !defined(BTM_NO_SHANI)
#define BTM_HAVE_SHANI 1
#endif

namespace {

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
inline uint32_t bswap32(uint32_t x) { return __builtin_bswap32(x); }

const uint32_t IV[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};

const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

#define S0(x) (rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22))
#define S1(x) (rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25))
#define s0(x) (rotr(x, 7) ^ rotr(x, 18) ^ ((x) >> 3))
#define s1(x) (rotr(x, 17) ^ rotr(x, 19) ^ ((x) >> 10))

// One compression of a 16-word (already big-endian-decoded) block.
void compress(uint32_t state[8], const uint32_t w_in[16]) {
  uint32_t w[64];
  std::memcpy(w, w_in, 64);
  for (int i = 16; i < 64; ++i)
    w[i] = w[i - 16] + s0(w[i - 15]) + w[i - 7] + s1(w[i - 2]);

  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];

#define ROUND(i)                                             \
  do {                                                       \
    uint32_t t1 = h + S1(e) + ((e & f) ^ (~e & g)) + K[i] + w[i]; \
    uint32_t t2 = S0(a) + ((a & b) ^ (a & c) ^ (b & c));     \
    h = g; g = f; f = e; e = d + t1;                         \
    d = c; c = b; b = a; a = t1 + t2;                        \
  } while (0)

  for (int i = 0; i < 64; i += 8) {
    ROUND(i); ROUND(i + 1); ROUND(i + 2); ROUND(i + 3);
    ROUND(i + 4); ROUND(i + 5); ROUND(i + 6); ROUND(i + 7);
  }
#undef ROUND

  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

#ifdef BTM_HAVE_SHANI
// SHA-NI compression (structure after the canonical public-domain x86
// SHA extensions sequence): state rides as (ABEF, CDGH) xmm pair; each
// loop group runs 4 rounds via two sha256rnds2 and advances the rolling
// 4-word message schedule with sha256msg1/msg2 + alignr.
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani(uint32_t state[8], const uint32_t w_in[16]) {
  __m128i TMP = _mm_loadu_si128((const __m128i*)&state[0]);     /* DCBA */
  __m128i STATE1 = _mm_loadu_si128((const __m128i*)&state[4]);  /* HGFE */
  TMP = _mm_shuffle_epi32(TMP, 0xB1);                           /* CDAB */
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);                     /* EFGH */
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);             /* ABEF */
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);                  /* CDGH */

  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;

  __m128i M[4];
  M[0] = _mm_loadu_si128((const __m128i*)&w_in[0]);
  M[1] = _mm_loadu_si128((const __m128i*)&w_in[4]);
  M[2] = _mm_loadu_si128((const __m128i*)&w_in[8]);
  M[3] = _mm_loadu_si128((const __m128i*)&w_in[12]);

  for (int g = 0; g < 16; ++g) {
    const __m128i KV = _mm_loadu_si128((const __m128i*)&K[4 * g]);
    __m128i MSG = _mm_add_epi32(M[g & 3], KV);
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    if (g >= 3 && g < 15) {
      const __m128i T = _mm_alignr_epi8(M[g & 3], M[(g + 3) & 3], 4);
      M[(g + 1) & 3] = _mm_add_epi32(M[(g + 1) & 3], T);
      M[(g + 1) & 3] = _mm_sha256msg2_epu32(M[(g + 1) & 3], M[g & 3]);
    }
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    if (g >= 1 && g < 13)
      M[(g + 3) & 3] = _mm_sha256msg1_epu32(M[(g + 3) & 3], M[g & 3]);
  }

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);                        /* FEBA */
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);                     /* DCHG */
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);                  /* DCBA */
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);                     /* HGFE */

  _mm_storeu_si128((__m128i*)&state[0], STATE0);
  _mm_storeu_si128((__m128i*)&state[4], STATE1);
}
// Two independent compressions interleaved. sha256rnds2 has multi-cycle
// latency and each compression is one serial dependency chain, so a
// single-buffer loop leaves the SHA unit idle most cycles; interleaving N
// independent (state, message) chains overlaps one chain's latency with the
// others' issue — the classic multi-buffer trick from Intel's SHA sample
// code, generalized over N. N=2 is the sweet spot on Xeons (1.6x over
// single-buffer); wider interleaves spill the per-lane state (6 xmm each)
// faster than they hide rnds2 latency.
//
// NOTE the build flags (backends/native.py): this TU deliberately avoids
// -march=native. SHA instructions exist only in legacy (non-VEX) encoding,
// and on AVX-512 Xeons executing them with dirty upper YMM/ZMM state puts
// the core in a heavily-penalized mode (~80x when gcc's native codegen
// emitted zmm moves around the loop). VEX-128-only flags keep the uppers
// clean TU-wide.
template <int N>
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani_xn(uint32_t states[][8], const uint32_t ws[][16]) {
  __m128i S0[N], S1[N], SAVE0[N], SAVE1[N], M[N][4];
  for (int n = 0; n < N; ++n) {
    __m128i TMP = _mm_loadu_si128((const __m128i*)&states[n][0]);
    S1[n] = _mm_loadu_si128((const __m128i*)&states[n][4]);
    TMP = _mm_shuffle_epi32(TMP, 0xB1);
    S1[n] = _mm_shuffle_epi32(S1[n], 0x1B);
    S0[n] = _mm_alignr_epi8(TMP, S1[n], 8);
    S1[n] = _mm_blend_epi16(S1[n], TMP, 0xF0);
    SAVE0[n] = S0[n];
    SAVE1[n] = S1[n];
    for (int i = 0; i < 4; ++i)
      M[n][i] = _mm_loadu_si128((const __m128i*)&ws[n][4 * i]);
  }

  for (int g = 0; g < 16; ++g) {
    const __m128i KV = _mm_loadu_si128((const __m128i*)&K[4 * g]);
    __m128i MSG[N];
    for (int n = 0; n < N; ++n) {
      MSG[n] = _mm_add_epi32(M[n][g & 3], KV);
      S1[n] = _mm_sha256rnds2_epu32(S1[n], S0[n], MSG[n]);
    }
    if (g >= 3 && g < 15) {
      for (int n = 0; n < N; ++n) {
        const __m128i T = _mm_alignr_epi8(M[n][g & 3], M[n][(g + 3) & 3], 4);
        M[n][(g + 1) & 3] = _mm_add_epi32(M[n][(g + 1) & 3], T);
        M[n][(g + 1) & 3] =
            _mm_sha256msg2_epu32(M[n][(g + 1) & 3], M[n][g & 3]);
      }
    }
    for (int n = 0; n < N; ++n) {
      MSG[n] = _mm_shuffle_epi32(MSG[n], 0x0E);
      S0[n] = _mm_sha256rnds2_epu32(S0[n], S1[n], MSG[n]);
    }
    if (g >= 1 && g < 13)
      for (int n = 0; n < N; ++n)
        M[n][(g + 3) & 3] = _mm_sha256msg1_epu32(M[n][(g + 3) & 3],
                                                 M[n][g & 3]);
  }

  for (int n = 0; n < N; ++n) {
    S0[n] = _mm_add_epi32(S0[n], SAVE0[n]);
    S1[n] = _mm_add_epi32(S1[n], SAVE1[n]);
    __m128i TMP = _mm_shuffle_epi32(S0[n], 0x1B);
    S1[n] = _mm_shuffle_epi32(S1[n], 0xB1);
    S0[n] = _mm_blend_epi16(TMP, S1[n], 0xF0);
    S1[n] = _mm_alignr_epi8(S1[n], TMP, 8);
    _mm_storeu_si128((__m128i*)&states[n][0], S0[n]);
    _mm_storeu_si128((__m128i*)&states[n][4], S1[n]);
  }
}
#endif  // BTM_HAVE_SHANI

typedef void (*compress_fn_t)(uint32_t[8], const uint32_t[16]);

#ifdef BTM_HAVE_SHANI
// Raw CPUID instead of __builtin_cpu_supports: g++ 10 compiles every SHA
// intrinsic this TU uses but rejects the "sha" argument to the builtin,
// which used to force the whole library onto the scalar path on a CPU
// whose /proc/cpuinfo says sha_ni. CPUID.(7,0):EBX bit 29 is SHA;
// CPUID.1:ECX bits 19/9 are SSE4.1/SSSE3 (the other ISAs the target
// attribute names).
bool cpu_has_shani() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
  if (!((ebx >> 29) & 1)) return false;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return ((ecx >> 19) & 1) && ((ecx >> 9) & 1);
}
#endif

compress_fn_t pick_compress() {
  // BTM_FORCE_SCALAR=1 pins the portable path — the only way to test the
  // scalar compressor on a SHA-NI machine.
  const char* force = std::getenv("BTM_FORCE_SCALAR");
  if (force != nullptr && force[0] == '1') return compress;
#ifdef BTM_HAVE_SHANI
  if (cpu_has_shani()) return compress_shani;
#endif
  return compress;
}

const compress_fn_t g_compress = pick_compress();

void load_be(uint32_t* w, const uint8_t* p, int nwords) {
  for (int i = 0; i < nwords; ++i) {
    uint32_t v;
    std::memcpy(&v, p + 4 * i, 4);
    w[i] = bswap32(v);
  }
}

void store_be(uint8_t* p, const uint32_t* w, int nwords) {
  for (int i = 0; i < nwords; ++i) {
    uint32_t v = bswap32(w[i]);
    std::memcpy(p + 4 * i, &v, 4);
  }
}

// Finish a SHA-256 whose first `absorbed` bytes (a multiple of 64) are
// already folded into `state`: absorb `data[0:len]` and pad for a total
// message length of absorbed + len. With absorbed == 0 and state == IV
// this is plain SHA-256 — the frontend's validate fast path resumes from
// a per-(session, job) coinbase-prefix midstate instead.
void sha256_resume(uint32_t state[8], uint64_t absorbed, const uint8_t* data,
                   size_t len) {
  size_t off = 0;
  uint32_t w[16];
  for (; off + 64 <= len; off += 64) {
    load_be(w, data + off, 16);
    g_compress(state, w);
  }
  // Final block(s) with padding.
  uint8_t tail[128];
  size_t rem = len - off;
  std::memcpy(tail, data + off, rem);
  tail[rem] = 0x80;
  size_t padded = (rem + 9 <= 64) ? 64 : 128;
  std::memset(tail + rem + 1, 0, padded - rem - 9);
  uint64_t bits = (absorbed + (uint64_t)len) * 8;
  for (int i = 0; i < 8; ++i) tail[padded - 1 - i] = (uint8_t)(bits >> (8 * i));
  for (size_t o = 0; o < padded; o += 64) {
    load_be(w, tail + o, 16);
    g_compress(state, w);
  }
}

void sha256(const uint8_t* data, size_t len, uint32_t state[8]) {
  std::memcpy(state, IV, 32);
  sha256_resume(state, 0, data, len);
}

// Second hash of the first digest: 32-byte message in one padded block.
inline void hash_digest(const uint32_t h1[8], uint32_t out[8]) {
  uint32_t w[16];
  std::memcpy(w, h1, 32);
  w[8] = 0x80000000u;
  for (int i = 9; i < 15; ++i) w[i] = 0;
  w[15] = 256;  // 32 bytes * 8
  std::memcpy(out, IV, 32);
  g_compress(out, w);
}

// digest (as 8 BE words, i.e. the natural SHA-256 output order) vs target
// given as 32 big-endian bytes. Bitcoin compares the digest bytes reversed,
// as a big-endian number, against the BE target: most significant byte of the
// reversed digest is digest byte 31 == low byte of word 7, i.e. compare
// bswap32(word[7]), bswap32(word[6]), ... lexicographically.
inline bool meets_target(const uint32_t h2[8], const uint32_t target_limbs[8]) {
  for (int i = 7; i >= 0; --i) {
    uint32_t d = bswap32(h2[i]);
    uint32_t t = target_limbs[7 - i];
    if (d < t) return true;
    if (d > t) return false;
  }
  return true;  // equal counts as meeting the target (hash <= target)
}

// Shared hit recording for every scan loop: word-7 early reject at
// difficulty >= 1, full lexicographic compare on near-hits, capped store
// with uncapped count.
inline void record_hit(const uint32_t h2[8], uint32_t nonce,
                       const uint32_t target_limbs[8], uint32_t* hit_nonces,
                       uint32_t max_hits, uint64_t* hits) {
  if (__builtin_expect(h2[7] == 0 || target_limbs[0] != 0, 0)) {
    if (meets_target(h2, target_limbs)) {
      if (*hits < max_hits) hit_nonces[*hits] = nonce;
      ++*hits;
    }
  }
}

#ifdef BTM_HAVE_SHANI
// The interleaved scan hot loop. All vector code in this TU is VEX-128
// (see the build note above), so no dirty-upper hazards; the interleave
// width is a compile-time constant tuned for the rnds2 latency.
constexpr int INTERLEAVE = 2;  // best on a Xeon: 2 ahead of 3, 6 and 4

uint64_t scan_multi_shani(const uint32_t mid[8], const uint32_t w_template[16],
                          uint32_t nonce_start, uint64_t count,
                          const uint32_t target_limbs[8],
                          uint32_t* hit_nonces, uint32_t max_hits,
                          uint64_t* k_out) {
  constexpr int N = INTERLEAVE;
  uint32_t ws[N][16], d2[N][16], h1[N][8], h2[N][8];
  for (int n = 0; n < N; ++n) {
    std::memcpy(ws[n], w_template, 64);
    d2[n][8] = 0x80000000u;
    for (int i = 9; i < 15; ++i) d2[n][i] = 0;
    d2[n][15] = 256;
  }

  uint64_t hits = 0;
  uint64_t k = 0;
  for (; k + N <= count; k += N) {
    const uint32_t base = nonce_start + (uint32_t)k;
    for (int n = 0; n < N; ++n) {
      ws[n][3] = bswap32(base + (uint32_t)n);
      std::memcpy(h1[n], mid, 32);
    }
    compress_shani_xn<N>(h1, ws);
    for (int n = 0; n < N; ++n) {
      std::memcpy(d2[n], h1[n], 32);
      std::memcpy(h2[n], IV, 32);
    }
    compress_shani_xn<N>(h2, d2);
    for (int n = 0; n < N; ++n)
      record_hit(h2[n], base + (uint32_t)n, target_limbs, hit_nonces,
                 max_hits, &hits);
  }
  *k_out = k;
  return hits;
}
#endif  // BTM_HAVE_SHANI

}  // namespace

extern "C" {

const char* btm_backend() {
#ifdef BTM_HAVE_SHANI
  if (g_compress == compress_shani) return "shani";
#endif
  return "scalar";
}

void btm_sha256d(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint32_t h1[8], h2[8];
  sha256(data, len, h1);
  uint8_t d1[32];
  store_be(d1, h1, 8);
  sha256(d1, 32, h2);
  store_be(out, h2, 8);
}

// Fold `nblocks` whole 64-byte blocks into `state` (no padding) — the
// midstate precompute behind btm_validate_share: the frontend absorbs a
// coinbase prefix's whole blocks once per (session, job) here, then
// resumes per submit. state is read-written in place; pass the IV to
// start a fresh hash.
void btm_sha256_blocks(uint32_t state[8], const uint8_t* data,
                       uint32_t nblocks) {
  uint32_t w[16];
  for (uint32_t b = 0; b < nblocks; ++b) {
    load_be(w, data + 64 * (size_t)b, 16);
    g_compress(state, w);
  }
}

// Validate one Stratum share end to end in a SINGLE library call — the
// pool frontend's submit fast path. Per-call ctypes overhead
// is what kills naive "route each sha256d through the .so" designs (a
// hashlib double-SHA is already one OpenSSL call); this entry point does
// the whole coinbase-finish → merkle fold → header double-SHA → target
// compare chain in one crossing:
//
//   mid8/absorbed — SHA-256 state after the fixed coinbase prefix
//                   (coinb1 ‖ extranonce1), `absorbed` bytes (a multiple
//                   of 64) already folded in. mid8 == NULL means start
//                   from the IV (absorbed must then be 0) — the short-
//                   prefix case where no whole block precedes the tail.
//   tail          — the rest of the coinbase: prefix remainder ‖
//                   extranonce2 ‖ coinb2.
//   branch        — merkle branch, branch_n × 32 internal-order bytes,
//                   folded root = sha256d(root ‖ branch_i).
//   prefix36      — header bytes 0..35: version (LE) ‖ prevhash
//                   (internal order). ntime/nbits/nonce are appended LE
//                   after the computed merkle root.
//   target32      — 256-bit share target, 32 big-endian bytes.
//   digest_out    — sha256d(header), natural digest order (32 bytes).
//
// Returns 1 when the header hash meets the target (hash <= target as
// Bitcoin compares them), else 0.
int btm_validate_share(const uint32_t* mid8, uint64_t absorbed,
                       const uint8_t* tail, size_t tail_len,
                       const uint8_t* branch, uint32_t branch_n,
                       const uint8_t prefix36[36], uint32_t ntime,
                       uint32_t nbits, uint32_t nonce,
                       const uint8_t target32[32], uint8_t digest_out[32]) {
  // Coinbase txid: resume from the cached prefix midstate, then the
  // digest re-hash (32-byte single-block message).
  uint32_t h1[8], h2[8];
  if (mid8 != nullptr) std::memcpy(h1, mid8, 32);
  else std::memcpy(h1, IV, 32);
  sha256_resume(h1, absorbed, tail, tail_len);
  hash_digest(h1, h2);

  // Merkle fold: root = sha256d(root ‖ branch_i), all internal order.
  uint8_t node[64];
  store_be(node, h2, 8);
  for (uint32_t i = 0; i < branch_n; ++i) {
    std::memcpy(node + 32, branch + 32 * (size_t)i, 32);
    sha256(node, 64, h1);
    hash_digest(h1, h2);
    store_be(node, h2, 8);
  }

  // 80-byte header: prefix36 ‖ merkle root ‖ ntime ‖ nbits ‖ nonce (LE).
  uint8_t header[80];
  std::memcpy(header, prefix36, 36);
  std::memcpy(header + 36, node, 32);
  for (int i = 0; i < 4; ++i) {
    header[68 + i] = (uint8_t)(ntime >> (8 * i));
    header[72 + i] = (uint8_t)(nbits >> (8 * i));
    header[76 + i] = (uint8_t)(nonce >> (8 * i));
  }
  sha256(header, 80, h1);
  hash_digest(h1, h2);
  store_be(digest_out, h2, 8);

  uint32_t target_limbs[8];
  load_be(target_limbs, target32, 8);
  return meets_target(h2, target_limbs) ? 1 : 0;
}

void btm_midstate(const uint8_t first64[64], uint32_t out[8]) {
  uint32_t w[16];
  load_be(w, first64, 16);
  std::memcpy(out, IV, 32);
  g_compress(out, w);
}

// Scan nonces [nonce_start, nonce_start + count) over header76 (the fixed 76
// header bytes; nonce goes in LE at bytes 76..79). target32 is the 256-bit
// target as 32 big-endian bytes. Found nonces are appended to hit_nonces
// (capacity max_hits). Returns the number of hits written.
uint64_t btm_scan(const uint8_t header76[76], uint32_t nonce_start,
                  uint64_t count, const uint8_t target32[32],
                  uint32_t* hit_nonces, uint32_t max_hits) {
  uint32_t mid[8];
  btm_midstate(header76, mid);

  uint32_t tail[3];
  load_be(tail, header76 + 64, 3);

  uint32_t target_limbs[8];
  load_be(target_limbs, target32, 8);

  uint64_t hits = 0;
  uint32_t w[16];
  w[0] = tail[0]; w[1] = tail[1]; w[2] = tail[2];
  w[3] = 0;  // nonce slot, overwritten per nonce (keep the copy defined)
  w[4] = 0x80000000u;
  for (int i = 5; i < 15; ++i) w[i] = 0;
  w[15] = 640;  // 80 bytes * 8 bits

  uint64_t k = 0;
#ifdef BTM_HAVE_SHANI
  if (g_compress == compress_shani) {
    // INTERLEAVE nonces per iteration through the multi-buffer
    // compressor; the odd tail falls through to the single-buffer loop.
    hits = scan_multi_shani(mid, w, nonce_start, count, target_limbs,
                            hit_nonces, max_hits, &k);
  }
#endif
  for (; k < count; ++k) {
    uint32_t nonce = nonce_start + (uint32_t)k;
    // Header stores the nonce LE; SHA-256 reads the block big-endian, so the
    // schedule word is the byte-swapped nonce.
    w[3] = bswap32(nonce);
    uint32_t h1[8], h2[8];
    std::memcpy(h1, mid, 32);
    g_compress(h1, w);
    hash_digest(h1, h2);
    record_hit(h2, nonce, target_limbs, hit_nonces, max_hits, &hits);
  }
  return hits;
}

}  // extern "C"
