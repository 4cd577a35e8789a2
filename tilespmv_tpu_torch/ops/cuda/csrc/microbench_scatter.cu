// Scatter microbenchmark for sm_90a: the stream kernel's round walk
// against the offsets encoding the TPU rejected, on inputs held in shared
// memory for the whole launch.
//
// Replaces scripts/microbench_scatter.py:make_kernel / run (the
// pallas_call at :98), the reference's rounds-vs-offs microbenchmark.
// One step walks S = 13 slabs of csum (S*8, 128) f32 with the int8 index
// planes pe (2496, 128) and writes out (8, 128) f32. Slab s reads csum
// rows s*8..s*8+7 (cs); a lane gather g(a, row0)[i, l] = a[i, pe[row0 +
// i, l]].
//   rounds:      for round t < 8, slab s, o = t*3*S*8 + s*8: target (q, l)
//                adds cs[src, pe[o + src, l]] - cs[src, pe[S*8 + o + src,
//                l]], src = pe[2*S*8 + o + q, l] (pe in [0, 8)): the loop
//                of stream.cu's round walk with the slab's csum made;
//   offs:        per slab (pe rows from base = s*96) diff = g(cs, base) -
//                g(cs, base + 8), then 8 picks g(diff, base + (2 + d)*8)
//                that depend on diff, pick d rolled down by d sublanes;
//   offs_nodep:  the picks read cs (no diff); offs_noroll: no roll.
// The TPU kernel's inputs had constant index maps, so Pallas held csum
// and pe in VMEM for the whole grid. Here too each block loads its inputs
// into shared memory once a launch, and no step reads csum or pe from
// global memory (microbench.cuh: a persistent grid walks the steps).
//
// The offs arms read pe rows 0-1247 only: csum (53,248 B), those rows
// (159,744 B) and two diff buffers (8,192 B) fit one block. rounds reads
// all 2496 rows (319,488 B), so a step is computed by a cluster of two
// blocks: block k holds csum and the rows of rounds 4k..4k+3 (212,992 B)
// and walks those rounds; block 1 hands its partial to block 0 through
// distributed shared memory, one barrier phase a step. A block has 1024
// threads, one target (q, l) = (tid / 128, tid % 128) each: with one
// resident block an SM, warps hide the latency of the dependent loads.
// rounds walks the slabs and, in each, its 4 rounds; offs* write each
// slab's diff into one of two buffers (one sync a slab) and the roll is
// index arithmetic on the source row: target (q, l) adds pick d of row
// (q - d) & 7. A sync (offs*) or the cluster barrier (rounds) ends each
// step, which also keeps the step's shared loads inside it: the inputs
// are the same in every step.
//
// Bound: shared-memory wavefronts of the byte loads from pe and of the
// csum gathers with their bank conflicts, and the latency of rounds'
// chain of three dependent loads. The layouts are the inputs' own
// (row-major), so a rounds load of e at rows src in [0, 8) meets up to 4
// rows in a bank, and its csum gathers, with lanes in [0, 8), 8 banks:
// those conflicts are not stream.cu's, whose lanes span [0, 128). The
// step's count of wavefronts for given inputs is
// tilespmv_tpu_torch/scripts/microbench_scatter.py:wavefronts. Indices
// are masked to their range so that no input reads outside csum. Every
// unit computes and stores the whole (8, 128) result (identical values):
// the stores keep the work live.
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "microbench.cuh"

namespace {

namespace cg = cooperative_groups;
using tsp_mb::kThreads;

constexpr int kSlabs = 13;
constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kRounds = 8;
constexpr int kSb8 = kSlabs * kSubs;
constexpr int kCsum = kSb8 * kLanes;           // floats of csum
constexpr int kOffsRows = 96;                  // pe rows per slab in offs*
constexpr int kPeBytes = kSlabs * kOffsRows * kLanes;  // rows a block holds
constexpr int kBuf = kSubs * kLanes;           // floats of a diff / partial

enum Arm { kRoundsArm = 0, kOffs = 1, kOffsNodep = 2, kOffsNoroll = 3 };

static_assert(kThreads == kSubs * kLanes, "a thread per target");
static_assert(kRounds / 2 * 3 * kSb8 * kLanes == kPeBytes,
              "half the rounds' rows are the offs arms' rows");

template <int ARM>
constexpr int kClusterOf = ARM == kRoundsArm ? 2 : 1;

// csum, this block's pe rows, and two buffers: rounds' partials, offs'
// and offs_noroll's diff
template <int ARM>
constexpr int smem_bytes() {
  return kCsum * 4 + kPeBytes + (ARM == kOffsNodep ? 0 : 2 * kBuf * 4);
}

template <int ARM>
__global__ void __launch_bounds__(kThreads, 1)
mb_scatter_kernel(const float* __restrict__ csum,
                  const signed char* __restrict__ pe,
                  float* __restrict__ out, int nsteps) {
  constexpr int kCluster = kClusterOf<ARM>;
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  signed char* pe_s = reinterpret_cast<signed char*>(cs + kCsum);
  float* buf = reinterpret_cast<float*>(pe_s + kPeBytes);
  const int tid = threadIdx.x;
  const int q = tid / kLanes;
  const int l = tid % kLanes;
  unsigned rank = 0;
  if constexpr (kCluster > 1) rank = cg::this_cluster().block_rank();

  // the inputs, once: csum, and pe rows rank * 1248 ..
  const float4* csum4 = reinterpret_cast<const float4*>(csum);
  for (int v = tid; v < kCsum / 4; v += kThreads) smem4[v] = csum4[v];
  const uint4* pe4 = reinterpret_cast<const uint4*>(pe + rank * kPeBytes);
  uint4* pe_s4 = reinterpret_cast<uint4*>(pe_s);
  for (int v = tid; v < kPeBytes / 16; v += kThreads) pe_s4[v] = pe4[v];
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  float* part_to = buf;
  if constexpr (kCluster > 1)
    part_to = cg::this_cluster().map_shared_rank(buf, 0);
  int n = 0;
  for (int step = blockIdx.x / kCluster; step < nsteps;
       step += gridDim.x / kCluster, ++n) {
    float acc = 0.f;
#pragma unroll 1
    for (int s = 0; s < kSlabs; ++s) {
      const float* cslab = cs + s * kSubs * kLanes;
      if constexpr (ARM == kRoundsArm) {
#pragma unroll
        for (int t = 0; t < kRounds / 2; ++t) {
          const signed char* pt = pe_s + t * 3 * kSb8 * kLanes;
          const int src =
              pt[(2 * kSb8 + s * kSubs + q) * kLanes + l] & (kSubs - 1);
          const int e = pt[(s * kSubs + src) * kLanes + l] & (kLanes - 1);
          const int st =
              pt[(kSb8 + s * kSubs + src) * kLanes + l] & (kLanes - 1);
          acc += cslab[src * kLanes + e] - cslab[src * kLanes + st];
        }
      } else {
        const signed char* pb = pe_s + s * kOffsRows * kLanes;
        const float* dsrc = cslab;
        if constexpr (ARM != kOffsNodep) {
          float* diff = buf + (s & 1) * kBuf;
          const int e = pb[q * kLanes + l] & (kLanes - 1);
          const int st = pb[(kSubs + q) * kLanes + l] & (kLanes - 1);
          diff[tid] = cslab[q * kLanes + e] - cslab[q * kLanes + st];
          __syncthreads();
          dsrc = diff;
        }
#pragma unroll
        for (int d = 0; d < kSubs; ++d) {
          const int i = ARM == kOffsNoroll ? q : ((q - d) & (kSubs - 1));
          const int c =
              pb[((2 + d) * kSubs + i) * kLanes + l] & (kLanes - 1);
          acc += dsrc[i * kLanes + c];
        }
      }
    }
    if constexpr (kCluster > 1) {
      tsp_mb::pair_combine(acc, rank, buf, part_to, n, out + tid);
    } else {
      __syncthreads();
      out[tid] = acc;
    }
  }
  if constexpr (kCluster > 1) tsp_mb::pair_done(rank, n);
}

template <int ARM>
int launch(const float* csum, const signed char* pe, float* out, int nsteps,
           int units, void* stream) {
  if (nsteps < 1 || units < 1 || units > nsteps)
    return static_cast<int>(cudaErrorInvalidValue);
  return tsp_mb::mb_launch(mb_scatter_kernel<ARM>, smem_bytes<ARM>(),
                           kClusterOf<ARM>, units, stream, csum, pe, out,
                           nsteps);
}

template <int ARM>
int grid_units(int* n, int* cluster) {
  *cluster = kClusterOf<ARM>;
  return tsp_mb::mb_units(mb_scatter_kernel<ARM>, smem_bytes<ARM>(),
                          kClusterOf<ARM>, n);
}

}  // namespace

// One launch of `nsteps` steps of arm 0 rounds, 1 offs, 2 offs_nodep,
// 3 offs_noroll by `units` units (1 <= units <= nsteps); any other arm or
// count returns cudaErrorInvalidValue, a refused launch its error.
extern "C" int tsp_mb_scatter(const float* csum, const signed char* pe,
                              float* out, int arm, int nsteps, int units,
                              void* stream) {
  switch (arm) {
    case kRoundsArm:
      return launch<kRoundsArm>(csum, pe, out, nsteps, units, stream);
    case kOffs: return launch<kOffs>(csum, pe, out, nsteps, units, stream);
    case kOffsNodep:
      return launch<kOffsNodep>(csum, pe, out, nsteps, units, stream);
    case kOffsNoroll:
      return launch<kOffsNoroll>(csum, pe, out, nsteps, units, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The most units of the arm's kernel resident at once into *n, and the
// blocks a unit into *cluster.
extern "C" int tsp_mb_scatter_grid(int arm, int* n, int* cluster) {
  switch (arm) {
    case kRoundsArm: return grid_units<kRoundsArm>(n, cluster);
    case kOffs: return grid_units<kOffs>(n, cluster);
    case kOffsNodep: return grid_units<kOffsNodep>(n, cluster);
    case kOffsNoroll: return grid_units<kOffsNoroll>(n, cluster);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
