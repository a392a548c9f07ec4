// scan_tile_kernel: one (hit count, lowest hit nonce) pair per step of
// `block` nonces and per version-rolled chain.
//
// Replaces bitcoin_miner_tpu/ops/sha256_pallas.py::_scan_tile_kernel
// (baseline layout, vshare = K, exact and word7 modes). Built once per K
// with -DVSHARE=K (1 <= K <= 8). Inputs: the job block of 16K+13 words,
// midstate x K | round3_state x K | tail3 | limbs | nonce_base | limit
// (29 words at K=1). Outputs: counts[n_steps*K] (int32) and
// mins[n_steps*K] (uint32, 0xFFFFFFFF for no hit), slot step*K + c for
// chain c; a step wholly past `limit` writes (0, 0xFFFFFFFF) in each of its
// slots. Nonces wrap modulo 2^32.
//
// Bound: 32-bit integer operations, about 2.5k per nonce at K=1 and
// about 1.2k more for each further chain, since the K chunk-2 compressions
// share one message schedule; three quarters of them are logic that only
// the 64-lane integer pipe runs (see ops/sha256_torch.py::bound_ms).
// 64K+52 bytes in and 8K bytes out per step, so memory plays no part.
// Design for that bound:
// - one thread block of 256 threads owns one step, each thread loops over
//   block/256 nonces; the TPU grid ran its steps in order, here blocks run
//   in any order, so nothing carries from one block to the next;
// - per nonce the schedule is expanded once and fed to K register states
//   (sha256d::nonce_meets); the job words are read from the block where
//   they are used, so the compiler chooses between holding them in
//   registers and reloading them (L1-resident) as K grows;
// - count and min reduce per chain in integers (__reduce_add_sync and
//   __reduce_min_sync per warp, then across the block's warps through a
//   [K][warps] shared array), where the TPU kernel reduced in float only
//   because its compiler had no integer vector reductions;
// - the rounds are fully unrolled (sha256d.cuh), so the message window and
//   the states stay in registers and the constants fold.
#include "sha256d.cuh"

#ifndef VSHARE
#error "build with -DVSHARE=K, 1 <= K <= 8"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChains = VSHARE;

template <int K, bool WORD7>
__global__ void __launch_bounds__(kThreads)
    scan_tile_kernel(const uint32_t* __restrict__ job_block,
                     int32_t* __restrict__ counts,
                     uint32_t* __restrict__ mins, uint32_t block) {
  const uint32_t base = job_block[16 * K + 11];
  const uint32_t limit = job_block[16 * K + 12];

  const uint32_t step = blockIdx.x;
  const uint32_t block_start = step * block;
  uint32_t count[K];
  uint32_t lowest[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    count[c] = 0;
    lowest[c] = 0xFFFFFFFFu;
  }
  if (block_start < limit) {
    for (uint32_t i = threadIdx.x; i < block; i += kThreads) {
      const uint32_t off = block_start + i;
      if (off >= limit) break;
      const uint32_t nonce = base + off;
      bool meets[K];
      sha256d::nonce_meets<K, WORD7>(job_block, nonce, meets);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (meets[c]) {
          ++count[c];
          lowest[c] = min(lowest[c], nonce);
        }
      }
    }
  }

  __shared__ uint32_t warp_count[K][kWarps];
  __shared__ uint32_t warp_lowest[K][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    count[c] = __reduce_add_sync(0xFFFFFFFFu, count[c]);
    lowest[c] = __reduce_min_sync(0xFFFFFFFFu, lowest[c]);
    if (lane == 0) {
      warp_count[c][warp] = count[c];
      warp_lowest[c][warp] = lowest[c];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kWarps;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const uint32_t n =
          __reduce_add_sync(0xFFFFFFFFu, live ? warp_count[c][lane] : 0u);
      const uint32_t m = __reduce_min_sync(
          0xFFFFFFFFu, live ? warp_lowest[c][lane] : 0xFFFFFFFFu);
      if (lane == 0) {
        counts[step * K + c] = static_cast<int32_t>(n);
        mins[step * K + c] = m;
      }
    }
  }
}

}  // namespace

extern "C" int scan_tile_launch(const uint32_t* job_block, int32_t* counts,
                                uint32_t* mins, int n_steps, unsigned block,
                                int word7, cudaStream_t stream) {
  if (word7) {
    scan_tile_kernel<kChains, true><<<n_steps, kThreads, 0, stream>>>(
        job_block, counts, mins, block);
  } else {
    scan_tile_kernel<kChains, false><<<n_steps, kThreads, 0, stream>>>(
        job_block, counts, mins, block);
  }
  return static_cast<int>(cudaGetLastError());
}
