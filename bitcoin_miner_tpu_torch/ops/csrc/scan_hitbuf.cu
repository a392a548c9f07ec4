// scan_hitbuf_kernel + hitbuf_compact_kernel: the hit-buffer scan of K
// version-rolled chains.
//
// Replaces the XLA scans bitcoin_miner_tpu/ops/sha256_jax.py::_scan_batch
// (K=1) and ::_scan_batch_vshare (K>1), exact and word7 modes. Built once
// per K with -DVSHARE=K (1 <= K <= 8), and per compile form with -DUNROLL=U
// or -DSPEC=0 (sha256d.cuh; at K > 1 only rolled forms: the reference's
// k-chain scan has no unfolded form). Inputs: midstates[K][8] (row 0 the
// caller's own header), tail3(3), limbs(8), nonce_base and limit, each a
// uint32 device buffer. Outputs per chain c: hits[c][max_hits] — the FIRST
// max_hits hit nonces in ascending offset order, unused slots 0xFFFFFFFF —
// and the uncapped hit count count[c], over the offsets below
// min(limit, capacity). Nonces wrap modulo 2^32.
//
// A global atomic append would keep a different subset of the hits once
// the count exceeds max_hits, so the order is built in two kernels:
// - scan_hitbuf_kernel: block b owns offsets [b*256*iters, (b+1)*256*iters)
//   and walks them 256 at a time. When any thread of the block hits in any
//   chain (__syncthreads_or), a ballot per warp and chain and the warps'
//   popcounts in a [K][warps] shared array give each hit its rank in its
//   chain, so the block stores each chain's first max_hits hits in offset
//   order into its own slot blk_hits[c][b], and its uncapped counts into
//   blk_counts[c][b]. Blocks wholly past the limit exit after one test;
//   nothing carries from one block to another. The K round-3 states are
//   derived once per block into shared memory beside the midstates, and
//   read from there where they are used.
// - hitbuf_compact_kernel, one block per chain (gridDim.x = K): an
//   exclusive scan of the chain's blk_counts gives each block's first rank;
//   blocks copy their stored hits to hits[c][rank..] while rank < max_hits,
//   and the total is count[c].
//
// Bound: 32-bit integer operations, as scan_tile_kernel (about 2.5k per
// nonce at K=1, about 1.2k more per further chain); the compaction moves
// K*n_blocks counts plus the hits it copies.
#include "sha256d.cuh"

#ifndef VSHARE
#error "build with -DVSHARE=K, 1 <= K <= 8"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCompactThreads = 1024;
constexpr int kChains = VSHARE;

template <int K, bool WORD7>
__global__ void __launch_bounds__(kThreads)
    scan_hitbuf_kernel(const uint32_t* __restrict__ midstates,
                       const uint32_t* __restrict__ tail3,
                       const uint32_t* __restrict__ limbs,
                       const uint32_t* __restrict__ nonce_base,
                       const uint32_t* __restrict__ limit_p,
                       uint32_t* __restrict__ blk_hits,
                       int32_t* __restrict__ blk_counts,
                       unsigned long long capacity, int max_hits,
                       int iters) {
  using L = sha256d::Layout<K>;
  __shared__ uint32_t job[L::kWords];
  for (int i = threadIdx.x; i < 8 * K; i += kThreads) {
    job[L::kMid + i] = midstates[i];
  }
  if (threadIdx.x < 3) job[L::kTail + threadIdx.x] = tail3[threadIdx.x];
  if (threadIdx.x < 8) job[L::kLimbs + threadIdx.x] = limbs[threadIdx.x];
  if (threadIdx.x < K) {
    sha256d::state3(midstates + 8 * threadIdx.x, tail3,
                    job + L::kState3 + 8 * threadIdx.x);
  }
  __syncthreads();
  const uint32_t base = __ldg(nonce_base);
  const unsigned long long limit = __ldg(limit_p);
  const unsigned long long n = limit < capacity ? limit : capacity;

  __shared__ uint32_t warp_hits[K][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned long long start =
      static_cast<unsigned long long>(blockIdx.x) * kThreads * iters;
  uint32_t stored[K];  // hits of this block so far (same in every thread)
#pragma unroll
  for (int c = 0; c < K; ++c) stored[c] = 0;
  for (int it = 0; it < iters; ++it) {
    const unsigned long long row = start + static_cast<unsigned long long>(it) * kThreads;
    if (row >= n) break;  // uniform across the block
    const unsigned long long off = row + threadIdx.x;
    const uint32_t nonce = base + static_cast<uint32_t>(off);
    bool hit[K];
    bool any = false;
    if (off < n) {
      sha256d::nonce_meets<K, WORD7>(job, nonce, hit);
#pragma unroll
      for (int c = 0; c < K; ++c) any |= hit[c];
    } else {
#pragma unroll
      for (int c = 0; c < K; ++c) hit[c] = false;
    }
    if (__syncthreads_or(any)) {
      uint32_t ballot[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        ballot[c] = __ballot_sync(0xFFFFFFFFu, hit[c]);
        if (lane == 0) warp_hits[c][warp] = __popc(ballot[c]);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < K; ++c) {
        uint32_t rank = stored[c] + __popc(ballot[c] & ((1u << lane) - 1u));
        uint32_t total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (w < warp) rank += warp_hits[c][w];
          total += warp_hits[c][w];
        }
        if (hit[c] && rank < static_cast<uint32_t>(max_hits)) {
          blk_hits[(static_cast<size_t>(c) * gridDim.x + blockIdx.x) *
                       max_hits + rank] = nonce;
        }
        stored[c] += total;
      }
      __syncthreads();  // warp_hits is rewritten by the next hitting row
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      blk_counts[static_cast<size_t>(c) * gridDim.x + blockIdx.x] =
          static_cast<int32_t>(stored[c]);
    }
  }
}

// Block c merges chain c: blk_hits[c][n_blocks][max_hits] and
// blk_counts[c][n_blocks] into hits[c][max_hits] and count[c].
__global__ void __launch_bounds__(kCompactThreads)
    hitbuf_compact_kernel(const uint32_t* __restrict__ blk_hits,
                          const int32_t* __restrict__ blk_counts,
                          int n_blocks, int max_hits,
                          uint32_t* __restrict__ hits,
                          int32_t* __restrict__ count) {
  const size_t chain = blockIdx.x;
  blk_hits += chain * n_blocks * max_hits;
  blk_counts += chain * n_blocks;
  hits += chain * max_hits;
  __shared__ uint32_t warp_sums[kCompactThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t cap = static_cast<uint32_t>(max_hits);
  uint32_t carry = 0;  // hits of all blocks before this chunk
  for (int c0 = 0; c0 < n_blocks; c0 += kCompactThreads) {
    const int b = c0 + threadIdx.x;
    const uint32_t v = b < n_blocks ? static_cast<uint32_t>(blk_counts[b]) : 0u;
    uint32_t x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      uint32_t t = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, t, d);
        if (lane >= d) t += y;
      }
      warp_sums[lane] = t;
    }
    __syncthreads();
    const uint32_t rank = carry + x - v + (warp > 0 ? warp_sums[warp - 1] : 0u);
    if (v > 0 && rank < cap) {
      const uint32_t take = min(min(v, cap), cap - rank);
      for (uint32_t k = 0; k < take; ++k) {
        hits[rank + k] = blk_hits[static_cast<size_t>(b) * max_hits + k];
      }
    }
    carry += warp_sums[kCompactThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  const uint32_t filled = min(carry, cap);
  for (int i = threadIdx.x; i < max_hits; i += kCompactThreads) {
    if (static_cast<uint32_t>(i) >= filled) hits[i] = 0xFFFFFFFFu;
  }
  if (threadIdx.x == 0) count[chain] = static_cast<int32_t>(carry);
}

}  // namespace

extern "C" int scan_hitbuf_launch(const uint32_t* midstates,
                                  const uint32_t* tail3,
                                  const uint32_t* limbs,
                                  const uint32_t* nonce_base,
                                  const uint32_t* limit, uint32_t* blk_hits,
                                  int32_t* blk_counts,
                                  unsigned long long capacity, int max_hits,
                                  int iters, int n_blocks, int word7,
                                  cudaStream_t stream) {
  if (word7) {
    scan_hitbuf_kernel<kChains, true><<<n_blocks, kThreads, 0, stream>>>(
        midstates, tail3, limbs, nonce_base, limit, blk_hits, blk_counts,
        capacity, max_hits, iters);
  } else {
    scan_hitbuf_kernel<kChains, false><<<n_blocks, kThreads, 0, stream>>>(
        midstates, tail3, limbs, nonce_base, limit, blk_hits, blk_counts,
        capacity, max_hits, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hitbuf_compact_launch(const uint32_t* blk_hits,
                                     const int32_t* blk_counts, int n_blocks,
                                     int max_hits, uint32_t* hits,
                                     int32_t* count, cudaStream_t stream) {
  hitbuf_compact_kernel<<<kChains, kCompactThreads, 0, stream>>>(
      blk_hits, blk_counts, n_blocks, max_hits, hits, count);
  return static_cast<int>(cudaGetLastError());
}
