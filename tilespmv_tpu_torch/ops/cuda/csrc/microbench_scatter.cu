// Scatter microbenchmark for sm_90a: the stream kernel's round walk
// against the offsets encoding the TPU rejected.
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
//                of stream.cu:95-105 with the slab's csum already made;
//   offs:        per slab (pe rows from base = s*96) diff = g(cs, base) -
//                g(cs, base + 8), then 8 picks g(diff, base + (2 + d)*8)
//                that depend on diff, pick d rolled down by d sublanes;
//   offs_nodep:  the picks read cs (no diff); offs_noroll: no roll.
// The TPU kernel held csum and pe in VMEM for the whole grid. Here one
// block of 256 threads per step loads csum (53,248 B) into dynamic shared
// memory (above the 48 KB static limit, so the kernel raises its
// cudaFuncAttributeMaxDynamicSharedMemorySize) and reads pe (319,488 B)
// from global memory, as stream.cu reads its planes; every block reads
// the same pe, so it stays in L2, and the step times the shared-memory
// walk without plane traffic from HBM. The step's time includes that
// csum load from L2 (which the TPU did not repeat per step), as
// stream.cu's includes its prefix. Each thread owns 4 of the 1024
// targets. rounds walks the rounds in registers; offs* write each slab's
// diff to shared memory (2 syncs per slab) and the roll is index
// arithmetic on the source row: target (q, l) adds pick d of row
// (q - d) & 7.
//
// Bound: latency of the dependent byte loads from pe (L1/L2) and the
// shared-memory gathers with their bank conflicts. rounds draws its lane
// indices from [0, 8), so its bank conflicts are not those of stream.cu,
// whose lanes span [0, 128). Indices are masked to their range (the
// masks are free beside the loads) so that no input reads outside csum.
// Every block computes and stores the whole (8, 128) result (identical
// values): the stores keep the work live.
#include <cuda_runtime.h>

namespace {

constexpr int kSlabs = 13;
constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kRounds = 8;
constexpr int kThreads = 256;
constexpr int kTargetsPerThread = kSubs * kLanes / kThreads;
constexpr int kSb8 = kSlabs * kSubs;
constexpr int kCsum = kSb8 * kLanes;       // floats of csum
constexpr int kOffsRows = 96;              // pe rows per slab in offs*

enum Arm { kRoundsArm = 0, kOffs = 1, kOffsNodep = 2, kOffsNoroll = 3 };

template <int ARM>
constexpr int smem_bytes() {
  return (kCsum + (ARM == kOffs || ARM == kOffsNoroll ? kSubs * kLanes : 0))
         * static_cast<int>(sizeof(float));
}

template <int ARM>
__global__ void __launch_bounds__(kThreads)
mb_scatter_kernel(const float* __restrict__ csum,
                  const signed char* __restrict__ pe,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* diff = cs + kCsum;                 // offs, offs_noroll only
  const int tid = threadIdx.x;
  const float4* csum4 = reinterpret_cast<const float4*>(csum);
  for (int v = tid; v < kCsum / 4; v += kThreads) smem4[v] = csum4[v];
  __syncthreads();
  float acc[kTargetsPerThread];
#pragma unroll
  for (int q = 0; q < kTargetsPerThread; ++q) acc[q] = 0.f;

  for (int s = 0; s < kSlabs; ++s) {
    const float* cslab = cs + s * kSubs * kLanes;
    if constexpr (ARM == kRoundsArm) {
#pragma unroll
      for (int q = 0; q < kTargetsPerThread; ++q) {
        const int idx = tid + q * kThreads;
        const int tq = idx >> 7;
        const int j = idx & (kLanes - 1);
        for (int t = 0; t < kRounds; ++t) {
          const signed char* pt = pe + t * 3 * kSb8 * kLanes;
          const int src =
              pt[(2 * kSb8 + s * kSubs + tq) * kLanes + j] & (kSubs - 1);
          const int e = pt[(s * kSubs + src) * kLanes + j] & (kLanes - 1);
          const int st =
              pt[(kSb8 + s * kSubs + src) * kLanes + j] & (kLanes - 1);
          acc[q] += cslab[src * kLanes + e] - cslab[src * kLanes + st];
        }
      }
    } else {
      const signed char* pb = pe + s * kOffsRows * kLanes;
      const float* dsrc = cslab;
      if constexpr (ARM != kOffsNodep) {
#pragma unroll
        for (int q = 0; q < kTargetsPerThread; ++q) {
          const int idx = tid + q * kThreads;
          const int i = idx >> 7;
          const int l = idx & (kLanes - 1);
          const int e = pb[i * kLanes + l] & (kLanes - 1);
          const int st = pb[(kSubs + i) * kLanes + l] & (kLanes - 1);
          diff[idx] = cslab[i * kLanes + e] - cslab[i * kLanes + st];
        }
        __syncthreads();
        dsrc = diff;
      }
#pragma unroll
      for (int q = 0; q < kTargetsPerThread; ++q) {
        const int idx = tid + q * kThreads;
        const int tq = idx >> 7;
        const int l = idx & (kLanes - 1);
#pragma unroll
        for (int d = 0; d < kSubs; ++d) {
          const int i = ARM == kOffsNoroll ? tq : ((tq - d) & (kSubs - 1));
          const int c =
              pb[((2 + d) * kSubs + i) * kLanes + l] & (kLanes - 1);
          acc[q] += dsrc[i * kLanes + c];
        }
      }
      if constexpr (ARM != kOffsNodep) __syncthreads();
    }
  }
#pragma unroll
  for (int q = 0; q < kTargetsPerThread; ++q) out[tid + q * kThreads] = acc[q];
}

template <int ARM>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      mb_scatter_kernel<ARM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<ARM>()));
}

template <int ARM>
int launch(const float* csum, const signed char* pe, float* out, int nsteps,
           void* stream) {
  const int err = set_smem<ARM>();
  if (err != 0) return err;
  if (nsteps > 0) {
    mb_scatter_kernel<ARM><<<nsteps, kThreads, smem_bytes<ARM>(),
                             static_cast<cudaStream_t>(stream)>>>(csum, pe,
                                                                  out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int ARM>
int occupancy(int* blocks_per_sm) {
  const int err = set_smem<ARM>();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mb_scatter_kernel<ARM>, kThreads, smem_bytes<ARM>()));
}

}  // namespace

// One launch of `nsteps` steps (blocks) of arm 0 rounds, 1 offs,
// 2 offs_nodep, 3 offs_noroll; any other arm returns
// cudaErrorInvalidValue.
extern "C" int tsp_mb_scatter(const float* csum, const signed char* pe,
                              float* out, int arm, int nsteps, void* stream) {
  switch (arm) {
    case kRoundsArm: return launch<kRoundsArm>(csum, pe, out, nsteps, stream);
    case kOffs: return launch<kOffs>(csum, pe, out, nsteps, stream);
    case kOffsNodep: return launch<kOffsNodep>(csum, pe, out, nsteps, stream);
    case kOffsNoroll:
      return launch<kOffsNoroll>(csum, pe, out, nsteps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of the arm's kernel, into *blocks_per_sm.
extern "C" int tsp_mb_scatter_occupancy(int arm, int* blocks_per_sm) {
  switch (arm) {
    case kRoundsArm: return occupancy<kRoundsArm>(blocks_per_sm);
    case kOffs: return occupancy<kOffs>(blocks_per_sm);
    case kOffsNodep: return occupancy<kOffsNodep>(blocks_per_sm);
    case kOffsNoroll: return occupancy<kOffsNoroll>(blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
