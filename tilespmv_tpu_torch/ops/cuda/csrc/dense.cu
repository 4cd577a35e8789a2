// Dense-tile class SpMV for sm_90a, f32, f64 and bf16 values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_dense_kernel (called by
// dense_class_call :679: the f32 one-hot route, and the df64 branch
// :378-409 as native FP64): for chunk c of step c/c_batch and lane t with
// xloc = meta[c, 0, t] >= 0,
//   yc[i] = sum_j val[c, j, i, t] * x[tilecol*16 + j],
//   tilecol = pb[step*K + (xloc >> 8)]*256 + (xloc & 255),
// added to y[(cw[step]*256 + meta[c, 1, t])*16 + i]. Lanes with
// xloc < 0 are inert padding. meta holds `meta_rows` rows a chunk: 2 on
// a one-hot plan, 2 + 2*ceil(256/T) on a prefix one (its boundary rows,
// which this kernel does not read: every lane routes by its own row 1;
// the chunk's lanes being sorted by row changes no sum), so chunk c's
// rows start at meta + c*meta_rows*T.
//
// Bound: the bytes of the active tiles' values (1 KB a tile in f32, 2 KB
// in f64, for 256 FMAs). At one RHS a value feeds one FMA (0.5 flop/B in
// f32, 0.25 in f64): the tensor cores have nothing to multiply, and TMA's
// bulk tiles would copy the inert lanes and zero columns skipped here.
// What pays is threads in flight, coalesced loads and fewer bytes. The
// planner pads each chunk's lanes at its end (mixed_large: 580 active
// tiles in 4,096 f32 lane slots, 12,766 in 19,712 f64 ones), so:
// * a block is one group of 32 lanes of one chunk and kWarps of the 16
//   tile rows (grid y covers the rest); warp w holds row i of the 32
//   tiles, so its loads of val[c][j][i][t0 .. t0+31] are coalesced;
// * the grid runs only the groups that hold an active lane (`groups`,
//   chunk*T + first lane, derived from meta);
// * the group's x blocks, all 16 values of each active tile, are staged
//   once in shared memory;
// * each tile's 16-bit nonzero-column mask (`cmask`, derived from val)
//   gates its value loads, so a warp fetches only the 32-byte sectors
//   where some lane has that column (f64 mixed_large: 10.7 of 26.3 MB);
//   a skipped value is its zero, and every product is still taken, so a
//   non-finite x meets 0 as in the Pallas kernel and dense_reference;
// * each (tile, row) sum is added with one atomicAdd (native for double
//   on sm_60 and later): tiles of one tile-row meet across chunks.
// The bf16 instance reads bf16 values (512 B a tile) and computes as the
// f32 one, on f32 x and y (values.cuh).
// scripts/dense_probes.py times this kernel against copies of it without
// the group list (every lane group, a block with no active lane exiting
// whole) or without the mask (every column), PERF.md.
#include <cuda_runtime.h>

#include "values.cuh"

namespace {

constexpr int kB = 16;       // tile edge
constexpr int kLanes = 32;   // chunk lanes (tiles) of one block: a warp's
constexpr int kWarps = 8;    // tile rows of one block: two 256-thread
                             // blocks per lane group

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// Val: the plan's value type; V: the compute type of x, y and the sums
template <typename Val, typename V = tsp::acc_t<Val>>
__global__ void __launch_bounds__(kLanes * kWarps)
dense_kernel(const Val* __restrict__ val, const int* __restrict__ meta,
             const int* __restrict__ cmask, const int* __restrict__ groups,
             const int* __restrict__ pb, const int* __restrict__ cw,
             const V* __restrict__ x, V* __restrict__ y, int t_lanes,
             int meta_rows, int k_panels, int c_batch) {
  __shared__ V xs[kLanes * (kB + 1)];   // +1: no bank conflicts over l
  const int g = groups[blockIdx.x];
  const int c = g / t_lanes;
  const int t0 = g - c * t_lanes;
  const int step = c / c_batch;
  const int* mc = meta + (long long)c * meta_rows * t_lanes + t0;
  const int l = threadIdx.x % kLanes;
  const int i = blockIdx.y * kWarps + threadIdx.x / kLanes;
  const bool active = mc[l] >= 0;
  const unsigned mask = active ? cmask[(long long)c * t_lanes + t0 + l] : 0u;
  // the values first: they do not wait for x
  const Val* v = val + ((long long)c * kB * kB + i) * t_lanes + t0 + l;
  V a[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    a[j] = (mask >> j & 1u) ? tsp::to_acc(v[(long long)j * kB * t_lanes])
                            : V(0);
  }
  // the group's x blocks, entry (tile, column) by thread: 16 neighbouring
  // threads read one tile's 16 values
  const int* pbs = pb + (long long)step * k_panels;
  for (int e = threadIdx.x; e < kLanes * kB; e += kLanes * kWarps) {
    const int loc = mc[e / kB];
    if (loc >= 0) {
      xs[e / kB * (kB + 1) + e % kB] =
          x[((long long)pbs[loc >> 8] * 256 + (loc & 255)) * kB + e % kB];
    }
  }
  if (!__syncthreads_or(active) || !active) return;
  const V* xl = xs + l * (kB + 1);
  V acc = 0;
#pragma unroll
  for (int j = 0; j < kB; ++j) acc = fmadd(a[j], xl[j], acc);
  atomicAdd(y + ((long long)cw[step] * 256 + mc[t_lanes + l]) * kB + i, acc);
}

// grid x: the `nblocks` lane groups; grid y: kWarps tile rows a block
template <typename Val, typename V>
int launch(const Val* val, const int* meta, const int* cmask,
           const int* groups, int nblocks, const int* pb, const int* cw,
           const V* x, V* y, int t_lanes, int meta_rows, int k_panels,
           int c_batch, void* stream) {
  if (t_lanes % kLanes || meta_rows < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks > 0) {
    dense_kernel<Val>
        <<<dim3(static_cast<unsigned>(nblocks), kB / kWarps),
           kLanes * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
            val, meta, cmask, groups, pb, cw, x, y, t_lanes, meta_rows,
            k_panels, c_batch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_dense(const float* val, const int* meta, const int* cmask,
                         const int* groups, int ngroups, const int* pb,
                         const int* cw, const float* x, float* y,
                         int t_lanes, int meta_rows, int k_panels,
                         int c_batch, void* stream) {
  return launch(val, meta, cmask, groups, ngroups, pb, cw, x, y, t_lanes,
                meta_rows, k_panels, c_batch, stream);
}

extern "C" int tsp_dense_f64(const double* val, const int* meta,
                             const int* cmask, const int* groups,
                             int ngroups, const int* pb, const int* cw,
                             const double* x, double* y, int t_lanes,
                             int meta_rows, int k_panels, int c_batch,
                             void* stream) {
  return launch(val, meta, cmask, groups, ngroups, pb, cw, x, y, t_lanes,
                meta_rows, k_panels, c_batch, stream);
}

extern "C" int tsp_dense_bf16(const __nv_bfloat16* val, const int* meta,
                              const int* cmask, const int* groups,
                              int ngroups, const int* pb, const int* cw,
                              const float* x, float* y, int t_lanes,
                              int meta_rows, int k_panels, int c_batch,
                              void* stream) {
  return launch(val, meta, cmask, groups, ngroups, pb, cw, x, y, t_lanes,
                meta_rows, k_panels, c_batch, stream);
}
