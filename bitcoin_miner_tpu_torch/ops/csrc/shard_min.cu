// shard_min_kernel: the least of n uint32 words, as one uint32 word.
//
// Replaces jnp.min(mins) and jnp.min(buf) in the shard_map bodies of
// bitcoin_miner_tpu/parallel/mesh.py (make_sharded_scan_fn,
// make_sharded_scan_fn_vshare, make_sharded_pallas_scan_fn): each shard's
// lowest output nonce (0xFFFFFFFF when it has none), whose pmin over the
// devices becomes a minimum over the shards' words on the host. Input: a
// shard's n_steps*K tile mins or its K*max_hits hit buffer; n = 0 writes
// 0xFFFFFFFF.
//
// Bound: bytes, 4n read and 4 written: a few KB at the main path's shapes,
// so the launch itself is the cost. One block of 1024 threads is enough: a
// strided loop in which neighbouring threads read neighbouring words,
// __reduce_min_sync within each warp, then warp 0 over the 32 warp minima.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    shard_min_kernel(const uint32_t* __restrict__ x, unsigned long long n,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_min[kThreads / 32];
  uint32_t m = 0xFFFFFFFFu;
  for (unsigned long long i = threadIdx.x; i < n; i += kThreads) {
    m = min(m, x[i]);
  }
  m = __reduce_min_sync(0xFFFFFFFFu, m);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_min_sync(0xFFFFFFFFu, warp_min[lane]);
    if (lane == 0) *out = m;
  }
}

}  // namespace

extern "C" int shard_min_launch(const uint32_t* x, unsigned long long n,
                                uint32_t* out, cudaStream_t stream) {
  shard_min_kernel<<<1, kThreads, 0, stream>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}
