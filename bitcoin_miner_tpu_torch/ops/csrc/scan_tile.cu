// scan_tile kernels: one (hit count, lowest hit nonce) pair per step of
// `block` nonces and per version-rolled chain, in each layout of the tile
// kernel.
//
// Replaces bitcoin_miner_tpu/ops/sha256_pallas.py::_scan_tile_kernel in
// every variant (baseline, regchain, wsplit, wstage, vroll, vroll-db),
// chain-pass size (cgroup) and interleave, exact and word7 modes. Every
// variant computes the same function on another schedule. One library per
// configuration, built with
//   -DVSHARE=K        chains, 1 <= K <= 8
//   -DVARIANT=v       index into sha256_tile.VARIANTS (default 0, baseline)
//   -DCGROUP=G        chains per pass over the rounds (default K)
//   -DINTERLEAVE=I    nonces in flight per thread (default 1)
//   -DUNROLL=U, -DSPEC=0  a compile form (sha256d.cuh): rolled round loops,
//                     or no partial evaluation of the padding and IV words
// Inputs: the job block of 16K+13 words, midstate x K | round3_state x K |
// tail3 | limbs | nonce_base | limit (29 words at K=1), on the card for
// the baseline, as launch parameters (copied from host memory) for the
// others. Outputs: counts[n_steps*K] (int32) and mins[n_steps*K] (uint32,
// 0xFFFFFFFF for no hit), slot step*K + c for chain c; a step wholly past
// `limit` writes (0, 0xFFFFFFFF) in each of its slots. On request, also
// the least of all mins as one word (`lowest`): the jnp.min(mins) of
// make_sharded_pallas_scan_fn's shard_map body
// (bitcoin_miner_tpu/parallel/mesh.py:291). Nonces wrap modulo 2^32.
// `block` is a multiple of 128 * I (of 256 * I for vroll-db).
//
// Bound: 32-bit integer operations, about 2.5k per nonce at K=1 and about
// 1.2k more for each further chain, since the K chunk-2 compressions share
// one message schedule; three quarters of them are logic that only the
// 64-lane integer pipe runs (see ops/sha256_torch.py::bound_ms). Passes of
// G < K chains re-expand the schedule (about 380 operations) once per
// pass; the staged layouts add 48 shared-memory stores per nonce and 48
// loads per nonce and pass. 64K+52 bytes in and 8K bytes out per step, so
// device memory plays no part.
//
// Design for that bound:
// - one thread block owns one step; the TPU grid ran its steps in order,
//   here blocks run in any order, so nothing carries from one block to the
//   next. Count and min reduce per chain in integers (warp reductions, then
//   across the block's warps through a [K][warps] shared array), where the
//   TPU kernel reduced in float only for its compiler's sake;
// - the rounds are fully unrolled (sha256d.cuh), so message windows and
//   states stay in registers and the round constants fold;
// - windowed layouts (baseline, regchain, wsplit): scan_tile_kernel and
//   scan_tile_param_kernel, up to 256 threads. Thread t takes the nonces
//   t + j*T of its step, I at a time as independent dataflow
//   (sha256d::chains_meet), the chains in passes of G. The baseline reads
//   each job word from the card where it is used, so the compiler chooses
//   between holding it in a register and reloading it (L1-resident) as K
//   grows. regchain and wsplit (regchain with one chain per pass by
//   default) take the job block as a __grid_constant__ kernel parameter
//   (at most 564 bytes): every job word is then a constant-bank operand of
//   the instruction that reads it, costing neither a register nor a load,
//   which is what the TPU's register-resident job block is for. The words
//   come from the host's copy at launch, never from the card;
// - staged layouts (wstage, vroll, vroll-db): scan_tile_staged_kernel, 128
//   threads and a dynamic shared-memory plane[slot][t][thread] of the
//   schedule words W[16..63] (48 words, 192 bytes per nonce and slot: 24 KB
//   per slot). Each loop body takes S slots (S = I, 2I for vroll-db): thread
//   t's nonce of slot v is row + v*128 + t. Phase 1 expands each slot's
//   schedule into the plane; a __syncwarp() then separates the phases, so
//   the compiler must load the words back instead of keeping the 48 stored
//   values live in registers (forwarding them would recreate the register
//   pressure the layout exists to remove). Phase 2 runs the chain passes
//   reading W[t] back, each word once per pass, a __syncwarp() before each
//   (slot, pass) so that no pass reuses an earlier pass's loads: wstage
//   slot by slot, vroll pass by pass over all slots (version-major),
//   vroll-db the same for each of its two groups of I slots, both groups
//   staged first. Each thread reads and writes only its own column, so the
//   barriers order nothing between threads, and a warp's 32 accesses hit
//   32 banks. At most 9 slots fit in a block's 227 KB.
// - warps per SM: the card hides a round's latencies with the other
//   resident warps, not with one thread's interleaved dataflow. Layouts at
//   8 warps per SM ran at 0.56-0.65 of their SASS bound, those at 16 or
//   more at 0.83-0.95. The builds that the thread count alone left at 8
//   (SCAN_TILE_MIN_BLOCKS) ask ptxas for the blocks that make 16: regchain
//   keeps its one pass of K chains behind one window, vroll-db its two
//   staged groups per body, whose passes other warps now overlap (past 4
//   chains the groups' passes run in a rolled loop, kRolledGroups);
//   vroll-db at two nonces in flight stages a partial plane (TilePlane).
// - the launch's least min, where asked for, is folded in by each block's
//   step epilogue (fold_lowest): one atomicMax of its complement into a
//   word of the stream's scratch, a fence and a ticket; the block that
//   draws the last copies the word out and leaves the scratch at 0 for the
//   next launch on the stream. A constant amount of work per block, no
//   second launch; without `lowest` the epilogue skips it all.
#include <string.h>

#include "sha256d.cuh"

#ifndef VSHARE
#error "build with -DVSHARE=K, 1 <= K <= 8"
#endif
#ifndef VARIANT
#define VARIANT 0
#endif
#ifndef CGROUP
#define CGROUP VSHARE
#endif
#ifndef INTERLEAVE
#define INTERLEAVE 1
#endif

// Blocks per SM that a build's launch bounds ask ptxas for, where the thread
// count alone left it at 8 warps per SM: regchain at more than 4 chains
// (one pass of all K chains: 175 registers at K=8, one block of 256
// threads) takes two blocks of 256, so at most 128 registers; vroll-db at
// more than 4 chains (its two staged groups' passes compiled to 254
// registers at K=8, two blocks of 128) and at two nonces in flight (four
// slots of the full plane, 96 KB: two blocks) takes four blocks of 128, so
// at most 128 registers and a quarter of the SM's shared memory. 16 warps
// per SM either way. Every other build keeps the one-argument bounds, which
// ptxas need not compile as a minimum of 1.
#if VARIANT == 1 && VSHARE > 4 && INTERLEAVE == 1
#define SCAN_TILE_MIN_BLOCKS 2
#elif VARIANT == 5 && (VSHARE > 4 || INTERLEAVE == 2)
#define SCAN_TILE_MIN_BLOCKS 4
#else
#define SCAN_TILE_MIN_BLOCKS 0
#endif
#if SCAN_TILE_MIN_BLOCKS
#define SCAN_TILE_BOUNDS(threads) \
  __launch_bounds__(threads, SCAN_TILE_MIN_BLOCKS)
#else
#define SCAN_TILE_BOUNDS(threads) __launch_bounds__(threads)
#endif

namespace {

// The order of ops/sha256_tile.py::VARIANTS.
enum Variant { kBaseline, kRegchain, kWsplit, kWstage, kVroll, kVrollDb };

constexpr int kChains = VSHARE;
constexpr int kGroup = CGROUP;
constexpr int kInterleave = INTERLEAVE;
constexpr Variant kVariant = static_cast<Variant>(VARIANT);
static_assert(kVariant >= kBaseline && kVariant <= kVrollDb, "VARIANT");
static_assert(1 <= kGroup && kGroup <= kChains, "1 <= CGROUP <= VSHARE");
static_assert(1 <= kInterleave, "INTERLEAVE >= 1");

constexpr int kMaxThreads = 256;    // windowed kernels
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStagedThreads = 128;  // staged kernels
constexpr int kMinBlocks = SCAN_TILE_MIN_BLOCKS;
constexpr int kSlots = (kVariant == kVrollDb ? 2 : 1) * kInterleave;
// Shared memory of an SM on the H100, what each resident block reserves of
// it, and store_step's arrays at 8 chains.
constexpr int kSmemPerSm = 233472;
constexpr int kSmemReserved = 1024;
constexpr int kStepArraysBytes = 2 * 8 * kMaxWarps * 4;
// The plane holds W[16..63] per nonce and slot (sha256d::Plane), but for
// vroll-db at two nonces in flight in a fully unrolled form, whose four
// slots must fit a quarter of the SM: a partial plane from W[18] (W[16] and
// W[17] read only the job) of the 27 words W[18..44] that fit (54 KB a
// block); each pass expands W[45..63] again from the words it loaded.
constexpr bool kPartialPlane =
    kVariant == kVrollDb && kInterleave == 2 && !sha256d::kRolled;
constexpr int kPlaneFirst = kPartialPlane ? 18 : 16;
constexpr int kPlaneWords =
    kPartialPlane ? (kSmemPerSm / (kMinBlocks > 0 ? kMinBlocks : 1) -
                     kSmemReserved - kStepArraysBytes) /
                        (kSlots * kStagedThreads * 4)
                  : 48;
using TilePlane = sha256d::Plane<kPlaneFirst, kPlaneWords>;
constexpr int kPlaneBytes = kSlots * kPlaneWords * kStagedThreads * 4;
// vroll-db at more than 4 chains runs its two groups' passes in a rolled
// loop: the same code for each group, one group after the other, both
// groups staged first. Unrolled, the two groups' 2K passes took 254
// registers at K=8, and spilled under a cap of 128; one group's K passes
// are vroll's, which fit 128 registers.
constexpr bool kRolledGroups = kVariant == kVrollDb && kChains > 4;
// regchain past 4 chains binds its chains' round-3 states to the nonce
// (sha256d::chains_meet's BIND), so that the job-only parts of their first
// rounds are not held across the nonce loop: under the two blocks' 128
// registers they spilled.
constexpr bool kBindStates = kVariant == kRegchain && kMinBlocks > 0;

// The job block as a kernel parameter: each word a constant-bank operand.
template <int K>
struct JobWords {
  uint32_t w[16 * K + 13];
  __device__ __forceinline__ uint32_t operator[](int i) const { return w[i]; }
};

// The launch's optional least min: `out` is null unless asked for;
// `scratch` is the stream's [ticket, complement of the least so far],
// both 0 between launches.
struct LaunchMin {
  uint32_t* out;
  unsigned* scratch;
};

// Fold a block's least min into the launch's, by one thread of the block.
// The block that draws the last ticket writes the launch's least min and
// sets both scratch words back to 0. The fold is an atomicMax of the
// complement, so a zeroed word stands for "no hit" (0xFFFFFFFF).
__device__ __forceinline__ void fold_lowest(uint32_t least, LaunchMin at) {
  atomicMax(at.scratch + 1, ~least);
  __threadfence();  // the fold is visible before the ticket
  if (atomicAdd(at.scratch, 1u) == gridDim.x - 1) {
    __threadfence();
    *at.out = ~atomicExch(at.scratch + 1, 0u);
    at.scratch[0] = 0u;  // every block has drawn
  }
}

// Reduce each chain's count and lowest nonce over the block, write the
// step's K slots, and fold their least into the launch's where asked.
template <int K>
__device__ __forceinline__ void store_step(uint32_t (&count)[K],
                                           uint32_t (&lowest)[K],
                                           int32_t* __restrict__ counts,
                                           uint32_t* __restrict__ mins,
                                           LaunchMin launch_min) {
  __shared__ uint32_t warp_count[K][kMaxWarps];
  __shared__ uint32_t warp_lowest[K][kMaxWarps];
  const uint32_t step = blockIdx.x;
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
    const bool live = lane < static_cast<int>(blockDim.x / 32);
    uint32_t least = 0xFFFFFFFFu;
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
      least = min(least, m);
    }
    if (lane == 0 && launch_min.out != nullptr) fold_lowest(least, launch_min);
  }
}

// Windowed layouts: thread t of the block takes offsets t + j*T, I at a
// time. One nonce in flight strides by 256 (a step of 128 nonces runs 128
// threads, the others 256); I > 1 strides by I x blockDim.x, with the block
// of 128 or 256 threads that makes each thread's count a multiple of I.
template <int K, int G, int I, bool WORD7, class Job>
__device__ __forceinline__ void windowed_step(const Job& job,
                                              int32_t* __restrict__ counts,
                                              uint32_t* __restrict__ mins,
                                              uint32_t block,
                                              LaunchMin launch_min) {
  const uint32_t base = job[16 * K + 11];
  const uint32_t limit = job[16 * K + 12];

  const uint32_t block_start = blockIdx.x * block;
  uint32_t count[K];
  uint32_t lowest[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    count[c] = 0;
    lowest[c] = 0xFFFFFFFFu;
  }
  if (block_start < limit) {
    const uint32_t stride = I == 1 ? kMaxThreads : I * blockDim.x;
    for (uint32_t i = threadIdx.x; i < block; i += stride) {
      uint32_t off[I];
      uint32_t nonce[I];
      off[0] = block_start + i;
      if (off[0] >= limit) break;
#pragma unroll
      for (int v = 0; v < I; ++v) {
        off[v] = block_start + i + v * blockDim.x;
        nonce[v] = base + off[v];
      }
      bool meets[I][K];
      sha256d::chains_meet<K, G, I, WORD7, kBindStates>(job, nonce, meets);
#pragma unroll
      for (int v = 0; v < I; ++v) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          if (meets[v][c] && (v == 0 || off[v] < limit)) {
            ++count[c];
            lowest[c] = min(lowest[c], nonce[v]);
          }
        }
      }
    }
  }
  store_step<K>(count, lowest, counts, mins, launch_min);
}

// baseline: the job block read from the card.
template <int K, int G, int I, bool WORD7>
__global__ void __launch_bounds__(kMaxThreads)
    scan_tile_kernel(const uint32_t* __restrict__ job_block,
                     int32_t* __restrict__ counts,
                     uint32_t* __restrict__ mins, uint32_t block,
                     const LaunchMin launch_min) {
  windowed_step<K, G, I, WORD7>(job_block, counts, mins, block, launch_min);
}

// regchain, wsplit: the job block as launch parameters.
template <int K, int G, int I, bool WORD7>
__global__ void SCAN_TILE_BOUNDS(kMaxThreads)
    scan_tile_param_kernel(const __grid_constant__ JobWords<K> job,
                           int32_t* __restrict__ counts,
                           uint32_t* __restrict__ mins, uint32_t block,
                           const LaunchMin launch_min) {
  windowed_step<K, G, I, WORD7>(job, counts, mins, block, launch_min);
}

// Phase 2 of the staged layouts, body J of S slots x P passes in the
// variant's order: wstage slot by slot (each slot's passes together),
// vroll and vroll-db pass by pass over each group of I slots
// (version-major). Each body follows a __syncwarp(), so its words are
// loaded afresh rather than held in registers from an earlier pass. The
// bodies recurse at compile time (a loop over them could exceed what the
// compiler unrolls).
template <int K, int G, int I, bool WORD7, Variant V, int S, int J = 0>
__device__ __forceinline__ void staged_passes(const JobWords<K>& job,
                                              const uint32_t (&nonce)[S],
                                              const bool (&live)[S],
                                              const uint32_t* col,
                                              uint32_t (&count)[K],
                                              uint32_t (&lowest)[K]) {
  constexpr int P = (K + G - 1) / G;
  if constexpr (J < S * P) {
    constexpr int v = V == kWstage ? J / P : J / (P * I) * I + J % I;
    constexpr int c0 = G * (V == kWstage ? J % P : J / I % P);
    constexpr int N = K - c0 < G ? K - c0 : G;
    __syncwarp();
    bool meets[N];
    sha256d::staged_pass<K, c0, N, kStagedThreads, WORD7, TilePlane>(
        job, nonce[v], col + v * kPlaneWords * kStagedThreads, meets);
#pragma unroll
    for (int g = 0; g < N; ++g) {
      if (meets[g] && live[v]) {
        ++count[c0 + g];
        lowest[c0 + g] = min(lowest[c0 + g], nonce[v]);
      }
    }
    staged_passes<K, G, I, WORD7, V, S, J + 1>(job, nonce, live, col, count,
                                               lowest);
  }
}

// wstage, vroll, vroll-db: the schedule plane in shared memory.
template <int K, int G, int I, bool WORD7, Variant V>
__global__ void SCAN_TILE_BOUNDS(kStagedThreads)
    scan_tile_staged_kernel(const __grid_constant__ JobWords<K> job,
                            int32_t* __restrict__ counts,
                            uint32_t* __restrict__ mins, uint32_t block,
                            const LaunchMin launch_min) {
  constexpr int T = kStagedThreads;
  constexpr int S = (V == kVrollDb ? 2 : 1) * I;  // slots per loop body
  extern __shared__ uint32_t plane[];  // [S][kPlaneWords][T]
  uint32_t* const col = plane + threadIdx.x;
  const uint32_t base = job[16 * K + 11];
  const uint32_t limit = job[16 * K + 12];

  const uint32_t block_start = blockIdx.x * block;
  uint32_t count[K];
  uint32_t lowest[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    count[c] = 0;
    lowest[c] = 0xFFFFFFFFu;
  }
  for (uint32_t r = 0; r < block; r += S * T) {
    const uint32_t row = block_start + r;
    if (row >= limit) break;  // uniform across the block
    uint32_t nonce[S];
    bool live[S];
#pragma unroll
    for (int v = 0; v < S; ++v) {
      const uint32_t off = row + v * T + threadIdx.x;
      live[v] = off < limit;
      nonce[v] = base + off;
    }
#pragma unroll
    for (int v = 0; v < S; ++v) {
      sha256d::stage_schedule<K, T, TilePlane>(job, nonce[v],
                                               col + v * kPlaneWords * T);
    }
    if constexpr (kRolledGroups) {
      // Group n holds slots nI .. nI + I - 1 (kRolledGroups).
#pragma unroll 1
      for (int n = 0; n < 2; ++n) {
        uint32_t group_nonce[I];
        bool group_live[I];
#pragma unroll
        for (int v = 0; v < I; ++v) {
          group_nonce[v] = n == 0 ? nonce[v] : nonce[I + v];
          group_live[v] = n == 0 ? live[v] : live[I + v];
        }
        staged_passes<K, G, I, WORD7, V, I>(job, group_nonce, group_live,
                                            col + n * I * kPlaneWords * T,
                                            count, lowest);
      }
    } else {
      staged_passes<K, G, I, WORD7, V, S>(job, nonce, live, col, count,
                                          lowest);
    }
  }
  store_step<K>(count, lowest, counts, mins, launch_min);
}

template <bool WORD7>
cudaError_t launch(const uint32_t* job_block, const uint32_t* job_host,
                   int32_t* counts, uint32_t* mins, LaunchMin launch_min,
                   int n_steps, unsigned block, cudaStream_t stream) {
  constexpr int K = kChains, G = kGroup, I = kInterleave;
  // Windowed: see windowed_step (block is a multiple of 128 * I).
  const unsigned threads = I == 1 ? (block < kMaxThreads ? block : kMaxThreads)
                           : block % (kMaxThreads * I) == 0 ? kMaxThreads
                                                            : 128;
  if constexpr (kVariant == kBaseline) {
    scan_tile_kernel<K, G, I, WORD7><<<n_steps, threads, 0, stream>>>(
        job_block, counts, mins, block, launch_min);
  } else {
    JobWords<K> job;
    memcpy(job.w, job_host, sizeof job.w);
    if constexpr (kVariant == kRegchain || kVariant == kWsplit) {
      scan_tile_param_kernel<K, G, I, WORD7><<<n_steps, threads, 0, stream>>>(
          job, counts, mins, block, launch_min);
    } else {
      const cudaError_t e = cudaFuncSetAttribute(
          scan_tile_staged_kernel<K, G, I, WORD7, kVariant>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kPlaneBytes);
      if (e != cudaSuccess) return e;
      scan_tile_staged_kernel<K, G, I, WORD7, kVariant>
          <<<n_steps, kStagedThreads, kPlaneBytes, stream>>>(
              job, counts, mins, block, launch_min);
    }
  }
  return cudaGetLastError();
}

template <bool WORD7>
cudaError_t occupancy(int* threads, int* shared_bytes, int* blocks_per_sm) {
  constexpr int K = kChains, G = kGroup, I = kInterleave;
  if constexpr (kVariant == kWstage || kVariant == kVroll ||
                kVariant == kVrollDb) {
    const auto kernel = scan_tile_staged_kernel<K, G, I, WORD7, kVariant>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPlaneBytes);
    if (e != cudaSuccess) return e;
    *threads = kStagedThreads;
    *shared_bytes = kPlaneBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kStagedThreads, kPlaneBytes);
  } else {
    *threads = kMaxThreads;
    *shared_bytes = 0;
    if constexpr (kVariant == kBaseline) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, scan_tile_kernel<K, G, I, WORD7>, kMaxThreads, 0);
    } else {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, scan_tile_param_kernel<K, G, I, WORD7>, kMaxThreads,
          0);
    }
  }
}

}  // namespace

// job_block: the job block on the card (read by the baseline); job_host:
// the same words in host memory (the launch parameters of the others).
// lowest: null unless the launch's least min is asked for; scratch: then
// the stream's two words, 0 between launches.
extern "C" int scan_tile_launch(const uint32_t* job_block,
                                const uint32_t* job_host, int32_t* counts,
                                uint32_t* mins, uint32_t* lowest,
                                unsigned* scratch, int n_steps,
                                unsigned block, int word7,
                                cudaStream_t stream) {
  const LaunchMin launch_min{lowest, scratch};
  return static_cast<int>(
      word7 ? launch<true>(job_block, job_host, counts, mins, launch_min,
                           n_steps, block, stream)
            : launch<false>(job_block, job_host, counts, mins, launch_min,
                            n_steps, block, stream));
}

// The launch shape of the default geometry (threads per block, dynamic
// shared bytes) and the blocks of it that fit on one SM.
extern "C" int scan_tile_occupancy(int word7, int* threads, int* shared_bytes,
                                   int* blocks_per_sm) {
  return static_cast<int>(
      word7 ? occupancy<true>(threads, shared_bytes, blocks_per_sm)
            : occupancy<false>(threads, shared_bytes, blocks_per_sm));
}
