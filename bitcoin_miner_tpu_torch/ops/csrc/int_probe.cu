// int_probe_kernel<ILP>: the card's 32-bit integer throughput, on the op
// mix of a SHA-256 round.
//
// Replaces _probe_kernel in benchmarks/vpu_probe.py (the pallas_call built
// by build_call): steps tiles of 8 x 128 uint32 lanes, each lane running ILP
// independent chains from seed + i, each chain `groups` iterations of
//   v += 0x9E3779B9;  v ^= v << (13 + (i & 3));  v += v >> 7
// (5 algorithmic operations: 2 adds, 3 logic), then the chains XOR-folded.
// The TPU grid's steps all write one output block; here every step writes
// its own row of a (steps, 8, 128) buffer, so that no step's work is dead to
// ptxas and identical writes do not race.
//
// Bound: operations. Nothing is read but the seed tile, once per lane. Per
// group and chain the two-pipe model of bound_ms gives 3 logic operations
// on the integer pipe and 5 through dispatch; ptxas makes 4 instructions of
// them (LOP3 and LEA.HI on the integer pipe, IMAD.SHL and VIADD on the FMA
// pipe), counted from the SASS by bitcoin_miner_tpu_torch/probes/int_probe.py.
//
// Design: ILP is a template parameter, so the chains live in registers (one
// entry point per ILP in {1, 2, 4, 8, 16}); groups is a run-time loop bound,
// as the reference's fori_loop is. The group loop runs kUnroll groups per
// iteration (a rolled outer loop, its body unrolled), then the remainder one
// group at a time, so the loop's counter, compare and branch are one in
// every kUnroll x ILP chain-groups. A step is four blocks of 256 threads,
// thread t of block 4s + q taking lane 256q + t of step s's tile: blocks of
// 256 leave the scheduler free to fill each SM to its 2048 threads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8 * 128;  // one (8, 128) tile
constexpr int kThreads = 256;
constexpr int kBlocksPerStep = kLanes / kThreads;
constexpr int kUnroll = 8;  // groups per iteration of the group loop

template <int ILP>
__device__ __forceinline__ void group(uint32_t (&v)[ILP]) {
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    uint32_t x = v[i] + 0x9E3779B9u;
    x ^= x << (13 + (i & 3));
    v[i] = x + (x >> 7);
  }
}

template <int ILP>
__global__ void __launch_bounds__(kThreads)
    int_probe_kernel(const uint32_t* __restrict__ seed, int groups,
                     uint32_t* __restrict__ out) {
  const int step = blockIdx.x / kBlocksPerStep;
  const int lane = (blockIdx.x % kBlocksPerStep) * kThreads + threadIdx.x;
  const uint32_t s = seed[lane];
  uint32_t v[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) v[i] = s + static_cast<uint32_t>(i);
  int g = 0;
#pragma unroll 1
  for (; g + kUnroll <= groups; g += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) group(v);
  }
#pragma unroll 1
  for (; g < groups; ++g) group(v);
  uint32_t acc = v[0];
#pragma unroll
  for (int i = 1; i < ILP; ++i) acc ^= v[i];
  out[static_cast<size_t>(step) * kLanes + lane] = acc;
}

template <int ILP>
int launch(const uint32_t* seed, int groups, int steps, uint32_t* out,
           cudaStream_t stream) {
  int_probe_kernel<ILP>
      <<<steps * kBlocksPerStep, kThreads, 0, stream>>>(seed, groups, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seed: the (8, 128) tile on the card; out: (steps, 8, 128). Each returns
// cudaGetLastError() after the launch.
#define INT_PROBE_ENTRY(ILP)                                                \
  extern "C" int int_probe_ilp##ILP##_launch(const uint32_t* seed,         \
                                             int groups, int steps,        \
                                             uint32_t* out,                \
                                             cudaStream_t stream) {        \
    return launch<ILP>(seed, groups, steps, out, stream);                  \
  }

INT_PROBE_ENTRY(1)
INT_PROBE_ENTRY(2)
INT_PROBE_ENTRY(4)
INT_PROBE_ENTRY(8)
INT_PROBE_ENTRY(16)
