// Gather microbenchmark for sm_90a: shared-memory gathers against the
// width of the staged row group.
//
// Replaces scripts/microbench_gather.py:make_kernel / run (the
// pallas_call at :45), the reference's lane-gather microbenchmark. One
// step reads src (512, 128) f32 at idx (512, 128) int8 in [0, 128) and
// writes out (8, 128) f32:
//   out[i, l] = sum over rows r = i (mod 8), ascending, of src[r, idx[r, l]].
// The TPU kernel held all of src in VMEM and issued 512/R lane gathers of
// (R, 128). src is 256 KB here, more than the 227 KB of shared memory a
// block can have, so one block per step (128 threads, one per lane l)
// stages group g's R rows (R * 512 B, 4-32 KB) into shared memory,
// syncs, and each thread gathers src_s[r - gR][idx[r, l]] with idx read
// from global memory (128 B per row; every block reads the same idx, so
// it stays in L1/L2). R thus sets shared memory per group against the
// number of syncs (2 per group, 512/R groups): that is the Hopper
// reading of "gather width". Each thread keeps 8 sums, so the fold adds
// in the TPU kernel's order.
//
// Bound: shared-memory bandwidth and bank conflicts of the random lane
// gathers (about 4-way for 32 random lanes of 128), the staging loads
// from L2, and the syncs. Indices are masked to [0, 128) so that no input
// reads outside the group. Every block computes and stores the whole
// (8, 128) result (identical values): the stores keep the work live.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 512;
constexpr int kLanes = 128;
constexpr int kSubs = 8;
constexpr int kThreads = kLanes;

template <int R>
__global__ void __launch_bounds__(kThreads)
mb_gather_kernel(const float* __restrict__ src,
                 const signed char* __restrict__ idx,
                 float* __restrict__ out) {
  __shared__ float4 src_s[R * kLanes / 4];
  const int l = threadIdx.x;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const float* rows = reinterpret_cast<const float*>(src_s);
  float acc[kSubs];
#pragma unroll
  for (int i = 0; i < kSubs; ++i) acc[i] = 0.f;

  for (int g = 0; g < kRows / R; ++g) {
#pragma unroll
    for (int v = l; v < R * kLanes / 4; v += kThreads)
      src_s[v] = src4[g * R * kLanes / 4 + v];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = idx[(g * R + r) * kLanes + l] & (kLanes - 1);
      acc[r % kSubs] += rows[r * kLanes + c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kSubs; ++i) out[i * kLanes + l] = acc[i];
}

template <int R>
int launch(const float* src, const signed char* idx, float* out, int nsteps,
           void* stream) {
  if (nsteps > 0) {
    mb_gather_kernel<R><<<nsteps, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(src, idx, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int occupancy(int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mb_gather_kernel<R>, kThreads, 0));
}

}  // namespace

// One launch of `nsteps` steps (blocks) at group width r in {8, 16, 32,
// 64}; any other r returns cudaErrorInvalidValue.
extern "C" int tsp_mb_gather(const float* src, const signed char* idx,
                             float* out, int r, int nsteps, void* stream) {
  switch (r) {
    case 8: return launch<8>(src, idx, out, nsteps, stream);
    case 16: return launch<16>(src, idx, out, nsteps, stream);
    case 32: return launch<32>(src, idx, out, nsteps, stream);
    case 64: return launch<64>(src, idx, out, nsteps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of the width-r kernel, into *blocks_per_sm.
extern "C" int tsp_mb_gather_occupancy(int r, int* blocks_per_sm) {
  switch (r) {
    case 8: return occupancy<8>(blocks_per_sm);
    case 16: return occupancy<16>(blocks_per_sm);
    case 32: return occupancy<32>(blocks_per_sm);
    case 64: return occupancy<64>(blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
