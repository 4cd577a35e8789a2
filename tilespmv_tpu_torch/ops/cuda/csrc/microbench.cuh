// The persistent grid of the two microbenchmark kernels
// (microbench_gather.cu, microbench_scatter.cu).
//
// A launch runs `units` units that walk the steps: unit c takes steps c,
// c + units, c + 2 * units, ... A unit is one block, or one cluster of
// kCluster blocks that compute each step together and exchange partial
// sums through distributed shared memory. Every kernel takes kThreads
// threads a block and one resident block an SM (its inputs fill most of
// the SM's shared memory), so the most units the card holds at once is
// the SM count, or the number of clusters that fit, as the occupancy
// calculator gives it (mb_units). The wrapper launches
// min(that, nsteps) units, so that no unit is idle and every unit of a
// launch of a whole multiple of it runs the same number of steps.
#pragma once

#include <cuda_runtime.h>

namespace tsp_mb {

constexpr int kThreads = 1024;

// One phase of the cluster barrier, split: arrive publishes this thread's
// shared and distributed-shared stores (release), wait returns once every
// thread of the cluster has arrived and makes their stores visible
// (acquire). A thread alternates them, arrive first.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// An arrive that publishes nothing: it orders no store, so it does not
// wait for this thread's stores to complete (a release arrive compiles
// to MEMBAR.ALL.GPU first, which waits for the global store of the last
// step's result).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of step number `n` (from 0) of a unit of two blocks: block 1
// stores its partial sum `acc` into buffer n % 2 of block 0's `part`
// (kThreads floats each; `part_to` is `part` mapped into block 0), block
// 0 adds it to its own and stores the sum at *out. Two buffers make one
// barrier phase a step enough: block 0 arrives once it has read the
// buffer of step n - 1, and block 1 waits for that phase before it
// overwrites the buffer of step n - 2. Block 0's arrive is relaxed: what
// it announces is a read, and that read has returned before the arrive
// issues, since the store of the step's sum consumed it. Block 1's
// arrive releases its store into block 0. After its last step a unit
// calls pair_done.
__device__ __forceinline__ void pair_combine(float acc, unsigned rank,
                                             const float* part,
                                             float* part_to, int n,
                                             float* out) {
  const int k = (n & 1) * kThreads + threadIdx.x;
  if (rank == 0) {
    cluster_arrive_relaxed();
    cluster_wait();
    *out = acc + part[k];
  } else {
    if (n > 0) cluster_wait();
    part_to[k] = acc;
    cluster_arrive();
  }
}

// Block 1 pairs its last arrive with a wait, so that both blocks leave
// after the unit's last phase (`steps`: the steps the unit ran).
__device__ __forceinline__ void pair_done(unsigned rank, int steps) {
  if (rank != 0 && steps > 0) cluster_wait();
}

// Raise the kernel's dynamic shared memory to `smem` bytes; then the most
// units resident at once into *units: SMs x blocks an SM for a one-block
// unit, cudaOccupancyMaxActiveClusters for a cluster.
template <typename Kernel>
int mb_units(Kernel kernel, int smem, int cluster, int* units) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cluster == 1) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    *units = per_sm * sms;
    return static_cast<int>(e);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms / cluster * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      units, reinterpret_cast<const void*>(kernel), &cfg));
}

// One launch of `units` units of `cluster` blocks on `stream`; returns
// the launch's error (a refused cluster or shared-memory size included).
template <typename... Params, typename... Args>
int mb_launch(void (*kernel)(Params...), int smem, int cluster, int units,
              void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tsp_mb
