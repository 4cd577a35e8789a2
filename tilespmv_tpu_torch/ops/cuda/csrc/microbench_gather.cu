// Gather microbenchmark for sm_90a: gathers from a table held in shared
// memory for the whole launch, against the width R of a row group.
//
// Replaces scripts/microbench_gather.py:make_kernel / run (the
// pallas_call at :45), the reference's lane-gather microbenchmark. One
// step reads src (512, 128) f32 at idx (512, 128) int8 in [0, 128) and
// writes out (8, 128) f32:
//   out[i, l] = sum over rows r = i (mod 8) of src[r, idx[r, l]].
// The TPU kernel's inputs had constant index maps, so Pallas copied src
// and idx into VMEM once and each grid step timed only the gathers. Here
// too the inputs are loaded once a launch and every step gathers from
// shared memory, never from global memory.
//
// src alone is 256 KB, more than the 227 KB of shared memory a block can
// have, so a step is computed by a cluster of two blocks on two SMs
// (microbench.cuh: a persistent grid of such clusters walks the steps).
// Block k holds rows 256k .. 256k + 255 of src (128 KB) and their idx
// (32 KB). Its 1024 threads are (i, l) = (tid / 128, tid % 128): thread
// (i, l) sums src[r, idx[r, l]] over the 32 rows r = i (mod 8) of its
// half, in ascending order. Block 1 stores its (8, 128) partial into
// block 0's shared memory (distributed shared memory; two buffers, so
// one split cluster barrier a step suffices), and block 0 adds it and
// stores the step's result. The barrier also keeps each step's shared
// loads inside the step: the inputs are the same in every step.
//
// R on Hopper. A group is R consecutive rows of the table, as on the TPU,
// where one (R, 128) lane gather took them. Each thread holds R / 8 of a
// group's rows: it loads their R / 8 index bytes in one shared load (a
// byte, a short, a word or two words; idx is laid out by group for that
// at load time), issues the R / 8 gathers, and only then adds them. R is
// thus the number of gathers a thread has in flight (1, 2, 4, 8) and
// sets how many index bytes one load brings; every R does the same
// 512 * 128 gathers a step. The group loop is not unrolled, so the
// compiler does not merge groups.
//
// Bound: shared-memory wavefronts. A warp's gather is 32 random columns
// of one 128-float row, 2.78 wavefronts on average for its bank
// conflicts; an index load is one wavefront (two for R = 64). The
// step's count of them for given inputs is
// tilespmv_tpu_torch/scripts/microbench_gather.py:wavefronts. Indices
// are masked to [0, 128) so that no input reads outside its row. Every
// cluster computes and stores the whole (8, 128) result (identical
// values): the stores keep the work live.
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "microbench.cuh"

namespace {

namespace cg = cooperative_groups;
using tsp_mb::kThreads;

constexpr int kRows = 512;
constexpr int kLanes = 128;
constexpr int kSubs = 8;
constexpr int kCluster = 2;
constexpr int kHalf = kRows / kCluster;             // rows a block holds
constexpr int kPerThread = kHalf / kSubs;           // rows a thread sums
constexpr int kSrcBytes = kHalf * kLanes * 4;       // 131,072
constexpr int kIdxBytes = kHalf * kLanes;           // 32,768
constexpr int kPartBytes = 2 * kThreads * 4;        // two partial buffers
constexpr int kSmem = kSrcBytes + kIdxBytes + kPartBytes;  // 172,032

static_assert(kThreads == kSubs * kLanes, "a thread per (i, l)");

// The `n` index bytes of a thread's group g, from idx laid out as
// [group][thread][n bytes]
template <int N>
__device__ __forceinline__ unsigned long long group_idx(
    const unsigned char* idx_s, int g, int tid) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "R in 8..64");
  const int k = g * kThreads + tid;
  if constexpr (N == 1) {
    return idx_s[k];
  } else if constexpr (N == 2) {
    return reinterpret_cast<const unsigned short*>(idx_s)[k];
  } else if constexpr (N == 4) {
    return reinterpret_cast<const unsigned int*>(idx_s)[k];
  } else {
    return reinterpret_cast<const unsigned long long*>(idx_s)[k];
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
mb_gather_kernel(const float* __restrict__ src,
                 const signed char* __restrict__ idx,
                 float* __restrict__ out, int nsteps) {
  constexpr int kPer = R / kSubs;            // gathers in flight a thread
  constexpr int kGroups = kPerThread / kPer;
  extern __shared__ float4 smem4[];
  float* src_s = reinterpret_cast<float*>(smem4);
  unsigned char* idx_s =
      reinterpret_cast<unsigned char*>(smem4) + kSrcBytes;
  float* part = reinterpret_cast<float*>(idx_s + kIdxBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int i = tid / kLanes;
  const int l = tid % kLanes;

  // the inputs, once: this block's half of src, and idx by group
  const float4* src4 =
      reinterpret_cast<const float4*>(src) + rank * (kSrcBytes / 16);
  for (int v = tid; v < kSrcBytes / 16; v += kThreads) smem4[v] = src4[v];
  const signed char* idx_h = idx + rank * kHalf * kLanes;
  for (int j = 0; j < kPerThread; ++j)
    idx_s[((j / kPer) * kThreads + tid) * kPer + j % kPer] =
        idx_h[(i + kSubs * j) * kLanes + l];
  // every block's inputs in place, and both blocks running before any
  // store into the other's shared memory
  cluster.sync();

  float* part_to = cluster.map_shared_rank(part, 0);
  const float* rows = src_s + i * kLanes;   // local row i + 8j at j * 1024
  int n = 0;
  for (int step = blockIdx.x / kCluster; step < nsteps;
       step += gridDim.x / kCluster, ++n) {
    float acc = 0.f;
#pragma unroll 1
    for (int g = 0; g < kGroups; ++g) {
      const unsigned long long c = group_idx<kPer>(idx_s, g, tid);
      float v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int col = static_cast<int>(c >> (8 * u)) & (kLanes - 1);
        v[u] = rows[(g * kPer + u) * kSubs * kLanes + col];
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) acc += v[u];
    }
    tsp_mb::pair_combine(acc, rank, part, part_to, n, out + tid);
  }
  tsp_mb::pair_done(rank, n);
}

template <int R>
int launch(const float* src, const signed char* idx, float* out, int nsteps,
           int units, void* stream) {
  if (nsteps < 1 || units < 1 || units > nsteps)
    return static_cast<int>(cudaErrorInvalidValue);
  return tsp_mb::mb_launch(mb_gather_kernel<R>, kSmem, kCluster, units,
                           stream, src, idx, out, nsteps);
}

template <int R>
int grid_units(int* n, int* cluster) {
  *cluster = kCluster;
  return tsp_mb::mb_units(mb_gather_kernel<R>, kSmem, kCluster, n);
}

}  // namespace

// One launch of `nsteps` steps at group width r in {8, 16, 32, 64} by
// `units` clusters (1 <= units <= nsteps); any other r or count returns
// cudaErrorInvalidValue, a refused launch its error.
extern "C" int tsp_mb_gather(const float* src, const signed char* idx,
                             float* out, int r, int nsteps, int units,
                             void* stream) {
  switch (r) {
    case 8: return launch<8>(src, idx, out, nsteps, units, stream);
    case 16: return launch<16>(src, idx, out, nsteps, units, stream);
    case 32: return launch<32>(src, idx, out, nsteps, units, stream);
    case 64: return launch<64>(src, idx, out, nsteps, units, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The most clusters of the width-r kernel resident at once into *n, and
// the blocks a cluster into *cluster.
extern "C" int tsp_mb_gather_grid(int r, int* n, int* cluster) {
  switch (r) {
    case 8: return grid_units<8>(n, cluster);
    case 16: return grid_units<16>(n, cluster);
    case 32: return grid_units<32>(n, cluster);
    case 64: return grid_units<64>(n, cluster);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
