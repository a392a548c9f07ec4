// scan_hitbuf_kernel: the hit-buffer scan of K version-rolled chains, in
// one launch.
//
// Replaces the XLA scans bitcoin_miner_tpu/ops/sha256_jax.py::_scan_batch
// (K=1) and ::_scan_batch_vshare (K>1), exact and word7 modes, with their
// ordered appends, and on request the jnp.min over the hit buffer of the
// shard_map bodies of bitcoin_miner_tpu/parallel/mesh.py (:164, :220).
// Built once per K with -DVSHARE=K (1 <= K <= 8), and per compile form
// with -DUNROLL=U or -DSPEC=0 (sha256d.cuh; at K > 1 only rolled forms:
// the reference's k-chain scan has no unfolded form). Inputs:
// midstates[K][8] (row 0 the caller's own header), tail3(3), limbs(8),
// nonce_base and limit, each a uint32 device buffer. Outputs per chain c:
// hits[c][max_hits] — the FIRST max_hits hit nonces in ascending offset
// order, unused slots 0xFFFFFFFF — and the uncapped hit count count[c],
// over the offsets below min(limit, capacity); where `lowest` is not null,
// the least word of hits[][] (0xFFFFFFFF when no chain hit). Nonces wrap
// modulo 2^32.
//
// A global atomic append would keep a different subset of the hits once
// the count exceeds max_hits, so the order is built in two stages of one
// launch:
// - block b owns offsets [b*256*iters, (b+1)*256*iters) and walks them 256
//   at a time. When any thread of the block hits in any chain
//   (__syncthreads_or), a ballot per warp and chain and the warps'
//   popcounts in a [K][warps] shared array give each hit its rank in its
//   chain, so the block stores each chain's first max_hits hits in offset
//   order into its own block slot blk_hits[c][b], and its uncapped counts
//   into blk_counts[c][b]. Blocks wholly past the limit stop after one
//   test and still write their counts. The K round-3 states are derived
//   once per block into shared memory beside the midstates, and read from
//   there where they are used.
// - every block then fences and draws a ticket on its stream's counter.
//   The block that draws the last merges each chain's block slots in block
//   order (merge_block_slots: an exclusive scan of the chain's blk_counts
//   gives each block slot its first rank, and the slot is copied to
//   hits[c][rank..] while rank < max_hits), takes the least word of the
//   rows it wrote if asked, and sets the counter back to 0 for the next
//   launch on the stream: no second launch and no memset. The block slots
//   (K x 2048 counts at 2^24 nonces) stay in L2. The merge takes 256
//   block slots a pass: 8 passes a chain at 2^24 nonces, 2048 at 2^32.
//
// Bound: 32-bit integer operations, as scan_tile_kernel (about 2.5k per
// nonce at K=1, about 1.2k more per further chain); the merge moves
// K*n_blocks counts plus the hits it copies, in the last block alone.
//
// rescan_steps_kernel: the tile hasher's exact re-enumeration of a
// dispatch's candidate steps, all of them in one launch. It replaces, on
// that path, one hit-buffer scan per step: the reference's _tile_rescan
// (bitcoin_miner_tpu/backends/tpu.py, make_scan_fn over one step, i.e.
// sha256_jax.py::_scan_batch and its ordered append) called once per
// candidate step. It is compiled into every build of this file and
// launched from the one-chain libraries in each compile form
// (scan_hitbuf, scan_hitbuf_u8, ..., scan_hitbuf_nospec).
// Inputs: the dispatch's job block of k chains (16k+13 words: midstates,
// round-3 states, tail3, limbs, nonce_base, limit; the tile kernel's) and S
// int32 slots step*k + c. Outputs per slot s, exact mode, over chain c's
// offsets [step*tile, step*tile + min(tile, limit - step*tile)) from
// nonce_base (modulo 2^32): hits[s][max_hits], the first max_hits hit
// nonces in ascending offset order (unused 0xFFFFFFFF), and count[s], the
// uncapped count.
//
// Bound: 32-bit integer operations, ops_per_nonce at k=1 in exact mode
// (about 2.6k) over the S*tile nonces; the outputs are S*(max_hits+1)
// words. The design keeps every SM busy at large S and makes S=1 one short
// launch:
// - block x is block b = x % bps of slot s = x / bps; each owns 128*iters
//   consecutive offsets of its step and walks them one nonce per thread per
//   iteration (ops/sha256_torch.py::rescan_geometry: S=1 at 8192 nonces
//   spreads over 64 blocks, one nonce a thread; large S takes the 32
//   nonces a thread of scan_hitbuf's 2^24 form, over many waves of blocks);
// - a block loads its chain's row (midstate, round-3 state from the job
//   block, tail, limbs) into shared memory once, and ranks its hits in
//   offset order as scan_hitbuf_kernel does;
// - with one block a slot it writes the slot's outputs itself; with
//   several, each writes its block slot to scratch (a few KB a slot: it
//   stays in L2), fences, and draws a ticket on the slot's counter. The
//   block that draws the last merges the slot's block slots in block order
//   (merge_block_slots, over one slot) and sets the counter back to 0.
#include "sha256d.cuh"

#ifndef VSHARE
#error "build with -DVSHARE=K, 1 <= K <= 8"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChains = VSHARE;
constexpr int kRescanThreads = 128;
constexpr int kRescanWarps = kRescanThreads / 32;

// Exclusive-scan merge of n_blocks block slots (counts blk_counts, hits
// blk_hits, max_hits words each) into one row of the outputs, by the block
// of THREADS threads that drew the last ticket, one block slot per thread
// and pass. Other blocks wrote the scratch: it is read past L1 (__ldcg).
// Kept out of line and one slot per thread: inlined, or taking several
// slots per thread, it made ptxas allocate the scan's nonce loop
// otherwise, with more instructions a nonce at some K.
template <int THREADS>
__device__ __noinline__ void merge_block_slots(
    const uint32_t* __restrict__ blk_hits, const int32_t* __restrict__ blk_counts,
    int n_blocks, int max_hits, uint32_t* __restrict__ hits,
    int32_t* __restrict__ count) {
  constexpr int kW = THREADS / 32;
  __shared__ uint32_t warp_sums[kW];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t cap = static_cast<uint32_t>(max_hits);
  uint32_t carry = 0;  // hits of all block slots before this pass
  for (int c0 = 0; c0 < n_blocks; c0 += THREADS) {
    const int b = c0 + threadIdx.x;
    const uint32_t v =
        b < n_blocks ? static_cast<uint32_t>(__ldcg(blk_counts + b)) : 0u;
    uint32_t x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      uint32_t t = lane < kW ? warp_sums[lane] : 0u;
#pragma unroll
      for (int d = 1; d < kW; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, t, d);
        if (lane >= d) t += y;
      }
      if (lane < kW) warp_sums[lane] = t;
    }
    __syncthreads();
    const uint32_t rank = carry + x - v + (warp > 0 ? warp_sums[warp - 1] : 0u);
    if (v > 0 && rank < cap) {
      const uint32_t take = min(min(v, cap), cap - rank);
      for (uint32_t i = 0; i < take; ++i) {
        hits[rank + i] =
            __ldcg(blk_hits + static_cast<size_t>(b) * max_hits + i);
      }
    }
    carry += warp_sums[kW - 1];
    __syncthreads();  // warp_sums is rewritten by the next pass
  }
  const uint32_t filled = min(carry, cap);
  for (int i = threadIdx.x; i < max_hits; i += THREADS) {
    if (static_cast<uint32_t>(i) >= filled) hits[i] = 0xFFFFFFFFu;
  }
  if (threadIdx.x == 0) *count = static_cast<int32_t>(carry);
}

// The tail of scan_hitbuf_kernel's last block: each chain's block slots
// merged into its row of hits and count, then, where `lowest` is set, the
// least word of those rows.
template <int K>
__device__ __forceinline__ void merge_chains(
    const uint32_t* __restrict__ blk_hits, const int32_t* __restrict__ blk_counts,
    int n_blocks, int max_hits, uint32_t* __restrict__ hits,
    int32_t* __restrict__ count, uint32_t* __restrict__ lowest) {
  for (int c = 0; c < K; ++c) {
    merge_block_slots<kThreads>(
        blk_hits + static_cast<size_t>(c) * n_blocks * max_hits,
        blk_counts + static_cast<size_t>(c) * n_blocks, n_blocks, max_hits,
        hits + static_cast<size_t>(c) * max_hits, count + c);
  }
  if (lowest == nullptr) return;
  __shared__ uint32_t warp_min[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // the block's merged rows are written
  uint32_t m = 0xFFFFFFFFu;
  for (int i = threadIdx.x; i < K * max_hits; i += kThreads) {
    m = min(m, hits[i]);
  }
  m = __reduce_min_sync(0xFFFFFFFFu, m);
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_min_sync(0xFFFFFFFFu,
                          lane < kWarps ? warp_min[lane] : 0xFFFFFFFFu);
    if (lane == 0) *lowest = m;
  }
}

template <int K, bool WORD7>
__global__ void __launch_bounds__(kThreads)
    scan_hitbuf_kernel(const uint32_t* __restrict__ midstates,
                       const uint32_t* __restrict__ tail3,
                       const uint32_t* __restrict__ limbs,
                       const uint32_t* __restrict__ nonce_base,
                       const uint32_t* __restrict__ limit_p,
                       uint32_t* __restrict__ blk_hits,
                       int32_t* __restrict__ blk_counts,
                       unsigned* __restrict__ ticket,
                       uint32_t* __restrict__ hits,
                       int32_t* __restrict__ count,
                       uint32_t* __restrict__ lowest,
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
  __shared__ bool last;
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
  __threadfence();  // this block's slots are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  merge_chains<K>(blk_hits, blk_counts, gridDim.x, max_hits, hits, count,
                  lowest);
  if (threadIdx.x == 0) *ticket = 0u;  // every block has drawn
}

// Grid: bps * S blocks of kRescanThreads. With bps == 1 the scratch and
// ticket pointers are unused (null).
__global__ void __launch_bounds__(kRescanThreads)
    rescan_steps_kernel(const uint32_t* __restrict__ block, int k,
                        const int32_t* __restrict__ slots, unsigned tile,
                        int max_hits, int iters, int bps,
                        uint32_t* __restrict__ blk_hits,
                        int32_t* __restrict__ blk_counts,
                        unsigned* __restrict__ tickets,
                        uint32_t* __restrict__ hits,
                        int32_t* __restrict__ count) {
  using L = sha256d::Layout<1>;
  __shared__ uint32_t job[L::kWords];
  __shared__ uint32_t warp_hits[kRescanWarps];
  __shared__ bool last;
  const unsigned ku = static_cast<unsigned>(k);
  const unsigned s = blockIdx.x / bps;
  const unsigned b = blockIdx.x % bps;
  // The slot's load and the job's own words are in flight together.
  const uint32_t slot = static_cast<uint32_t>(__ldg(slots + s));
  const uint32_t base = __ldg(block + 16 * ku + 11);
  const unsigned long long limit = __ldg(block + 16 * ku + 12);
  const uint32_t step = slot / ku;
  const uint32_t c = slot % ku;
  if (threadIdx.x < 8) {
    job[L::kMid + threadIdx.x] = __ldg(block + 8 * c + threadIdx.x);
    job[L::kState3 + threadIdx.x] = __ldg(block + 8 * (ku + c) + threadIdx.x);
    job[L::kLimbs + threadIdx.x] = __ldg(block + 16 * ku + 3 + threadIdx.x);
  }
  if (threadIdx.x < 3) {
    job[L::kTail + threadIdx.x] = __ldg(block + 16 * ku + threadIdx.x);
  }
  __syncthreads();
  const unsigned long long first = static_cast<unsigned long long>(step) * tile;
  const unsigned long long left = limit > first ? limit - first : 0ull;
  const unsigned long long n = left < tile ? left : tile;
  const uint32_t step_base = base + static_cast<uint32_t>(first);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned long long start =
      static_cast<unsigned long long>(b) * kRescanThreads * iters;
  uint32_t* out = bps == 1 ? hits + static_cast<size_t>(s) * max_hits
                           : blk_hits + static_cast<size_t>(blockIdx.x) * max_hits;
  uint32_t stored = 0;  // hits of this block so far (same in every thread)
  for (int it = 0; it < iters; ++it) {
    const unsigned long long row =
        start + static_cast<unsigned long long>(it) * kRescanThreads;
    if (row >= n) break;  // uniform across the block
    const unsigned long long off = row + threadIdx.x;
    const uint32_t nonce = step_base + static_cast<uint32_t>(off);
    bool hit[1] = {false};
    if (off < n) sha256d::nonce_meets<1, false>(job, nonce, hit);
    if (__syncthreads_or(hit[0])) {
      const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, hit[0]);
      if (lane == 0) warp_hits[warp] = __popc(ballot);
      __syncthreads();
      uint32_t rank = stored + __popc(ballot & ((1u << lane) - 1u));
      uint32_t total = 0;
#pragma unroll
      for (int w = 0; w < kRescanWarps; ++w) {
        if (w < warp) rank += warp_hits[w];
        total += warp_hits[w];
      }
      if (hit[0] && rank < static_cast<uint32_t>(max_hits)) out[rank] = nonce;
      stored += total;
      __syncthreads();  // warp_hits is rewritten by the next hitting row
    }
  }
  if (bps == 1) {
    const uint32_t filled = min(stored, static_cast<uint32_t>(max_hits));
    for (int i = threadIdx.x; i < max_hits; i += kRescanThreads) {
      if (static_cast<uint32_t>(i) >= filled) out[i] = 0xFFFFFFFFu;
    }
    if (threadIdx.x == 0) count[s] = static_cast<int32_t>(stored);
    return;
  }
  if (threadIdx.x == 0) blk_counts[blockIdx.x] = static_cast<int32_t>(stored);
  __threadfence();  // this block's slot is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + s, 1u) == static_cast<unsigned>(bps - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  merge_block_slots<kRescanThreads>(
      blk_hits + static_cast<size_t>(s) * bps * max_hits,
      blk_counts + static_cast<size_t>(s) * bps, bps, max_hits,
      hits + static_cast<size_t>(s) * max_hits, count + s);
  if (threadIdx.x == 0) tickets[s] = 0u;  // every block of s has drawn
}

}  // namespace

// blk_hits, blk_counts: scratch of K * n_blocks block slots; ticket: the
// stream's counter, 0 between launches; lowest: null unless asked for.
extern "C" int scan_hitbuf_launch(const uint32_t* midstates,
                                  const uint32_t* tail3,
                                  const uint32_t* limbs,
                                  const uint32_t* nonce_base,
                                  const uint32_t* limit, uint32_t* blk_hits,
                                  int32_t* blk_counts, unsigned* ticket,
                                  uint32_t* hits, int32_t* count,
                                  uint32_t* lowest,
                                  unsigned long long capacity, int max_hits,
                                  int iters, int n_blocks, int word7,
                                  cudaStream_t stream) {
  if (word7) {
    scan_hitbuf_kernel<kChains, true><<<n_blocks, kThreads, 0, stream>>>(
        midstates, tail3, limbs, nonce_base, limit, blk_hits, blk_counts,
        ticket, hits, count, lowest, capacity, max_hits, iters);
  } else {
    scan_hitbuf_kernel<kChains, false><<<n_blocks, kThreads, 0, stream>>>(
        midstates, tail3, limbs, nonce_base, limit, blk_hits, blk_counts,
        ticket, hits, count, lowest, capacity, max_hits, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rescan_steps_launch(const uint32_t* block, int k,
                                   const int32_t* slots, int n_slots,
                                   unsigned tile, int max_hits, int iters,
                                   int bps, uint32_t* blk_hits,
                                   int32_t* blk_counts, unsigned* tickets,
                                   uint32_t* hits, int32_t* count,
                                   cudaStream_t stream) {
  const unsigned long long n_blocks =
      static_cast<unsigned long long>(n_slots) * bps;
  rescan_steps_kernel<<<static_cast<unsigned>(n_blocks), kRescanThreads, 0,
                        stream>>>(block, k, slots, tile, max_hits, iters, bps,
                                  blk_hits, blk_counts, tickets, hits, count);
  return static_cast<int>(cudaGetLastError());
}
