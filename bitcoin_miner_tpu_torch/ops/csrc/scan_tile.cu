// scan_tile_kernel: one (hit count, lowest hit nonce) pair per step of
// `block` nonces.
//
// Replaces bitcoin_miner_tpu/ops/sha256_pallas.py::_scan_tile_kernel
// (baseline layout, vshare=1, exact and word7 modes). Inputs: the 29-word
// job block midstate(8) | round3_state(8) | tail3(3) | limbs(8) |
// nonce_base | limit. Outputs: counts[n_steps] (int32) and
// mins[n_steps] (uint32, 0xFFFFFFFF for a step without hits); a step
// wholly past `limit` writes (0, 0xFFFFFFFF). Nonces wrap modulo 2^32.
//
// Bound: 32-bit integer operations, about 2.5k per nonce, three quarters of
// them logic that only the 64-lane integer pipe runs (see
// ops/sha256_torch.py::bound_ms); 116 bytes in and 8 bytes out per step, so
// memory plays no part. Design for that bound:
// - one thread block of 256 threads owns one step, each thread loops over
//   block/256 nonces with the job block in registers; the TPU grid ran its
//   steps in order, here blocks run in any order, so nothing carries from
//   one block to the next;
// - count and min reduce in integers (__reduce_add_sync and
//   __reduce_min_sync per warp, then across the block's warps through
//   shared memory), where the TPU kernel reduced in float only because
//   its compiler had no integer vector reductions;
// - the rounds are fully unrolled (sha256d.cuh), so the message window and
//   the state stay in registers and the constants fold.
#include "sha256d.cuh"

namespace {

constexpr int kThreads = 256;

template <bool WORD7>
__global__ void __launch_bounds__(kThreads)
    scan_tile_kernel(const uint32_t* __restrict__ job_block,
                     int32_t* __restrict__ counts,
                     uint32_t* __restrict__ mins, uint32_t block) {
  sha256d::Job j;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    j.mid[i] = __ldg(job_block + i);
    j.s3[i] = __ldg(job_block + 8 + i);
    j.limbs[i] = __ldg(job_block + 19 + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) j.tail[i] = __ldg(job_block + 16 + i);
  const uint32_t base = __ldg(job_block + 27);
  const uint32_t limit = __ldg(job_block + 28);

  const uint32_t step = blockIdx.x;
  const uint32_t block_start = step * block;
  uint32_t count = 0;
  uint32_t lowest = 0xFFFFFFFFu;
  if (block_start < limit) {
    for (uint32_t i = threadIdx.x; i < block; i += kThreads) {
      const uint32_t off = block_start + i;
      if (off >= limit) break;
      const uint32_t nonce = base + off;
      if (sha256d::nonce_meets<WORD7>(j, nonce)) {
        ++count;
        lowest = min(lowest, nonce);
      }
    }
  }

  count = __reduce_add_sync(0xFFFFFFFFu, count);
  lowest = __reduce_min_sync(0xFFFFFFFFu, lowest);
  __shared__ uint32_t warp_count[kThreads / 32];
  __shared__ uint32_t warp_lowest[kThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_count[warp] = count;
    warp_lowest[warp] = lowest;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kThreads / 32;
    count = __reduce_add_sync(0xFFFFFFFFu, live ? warp_count[lane] : 0u);
    lowest = __reduce_min_sync(0xFFFFFFFFu,
                               live ? warp_lowest[lane] : 0xFFFFFFFFu);
    if (lane == 0) {
      counts[step] = static_cast<int32_t>(count);
      mins[step] = lowest;
    }
  }
}

}  // namespace

extern "C" int scan_tile_launch(const uint32_t* job_block, int32_t* counts,
                                uint32_t* mins, int n_steps, unsigned block,
                                int word7, cudaStream_t stream) {
  if (word7) {
    scan_tile_kernel<true><<<n_steps, kThreads, 0, stream>>>(
        job_block, counts, mins, block);
  } else {
    scan_tile_kernel<false><<<n_steps, kThreads, 0, stream>>>(
        job_block, counts, mins, block);
  }
  return static_cast<int>(cudaGetLastError());
}
