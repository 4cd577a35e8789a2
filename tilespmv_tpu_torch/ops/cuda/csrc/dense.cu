// Dense-tile class SpMV for sm_90a, f32 and f64.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_dense_kernel (called by
// dense_class_call: the f32 one-hot route, and the df64 branch :378-409
// as native FP64): for chunk c of step c/c_batch and lane t with
// xloc = meta[c, 0, t] >= 0,
//   yc[i] = sum_j val[c, j, i, t] * x[tilecol*16 + j],
//   tilecol = pb[step*K + (xloc >> 8)]*256 + (xloc & 255),
// added to y[(cw[step]*256 + meta[c, 1, t])*16 + i]. Lanes with
// xloc < 0 are inert padding and skipped.
//
// Bound: device-memory bytes (16*16 values per tile, 1 KB in f32 and 2 KB
// in f64, at 256 FMAs). The TPU routed each chunk to its window by a
// one-hot matmul; here one thread owns one tile (chunk, lane): it loads
// the tile's 16 x values once, keeps 16 row sums in registers, and adds
// them with atomicAdd (native for double on sm_60 and later), because
// several tiles of one chunk (or of chunks run by other blocks) can share
// a tile-row. An f64 plan's unique-row chunks carry many inert lanes;
// their threads return after one meta load. Lanes are the fastest
// dimension of val, so a warp's value loads are coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kB = 16;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename V>
__global__ void dense_kernel(const V* __restrict__ val,
                             const int* __restrict__ meta,
                             const int* __restrict__ pb,
                             const int* __restrict__ cw,
                             const V* __restrict__ x,
                             V* __restrict__ y, int nchunks,
                             int t_lanes, int k_panels, int c_batch) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nchunks * t_lanes) return;
  const int c = static_cast<int>(gid / t_lanes);
  const int t = static_cast<int>(gid % t_lanes);
  const int* mc = meta + (long long)c * 2 * t_lanes;
  const int xloc = mc[t];
  if (xloc < 0) return;
  const int step = c / c_batch;
  const V* xb =
      x + ((long long)pb[(long long)step * k_panels + (xloc >> 8)] * 256 +
           (xloc & 255)) * kB;
  V xv[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) xv[j] = xb[j];
  // val[c][j][i][t]
  const V* v = val + (long long)c * kB * kB * t_lanes + t;
  V acc[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) acc[i] = 0;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      acc[i] = fmadd(v[(long long)(j * kB + i) * t_lanes], xv[j], acc[i]);
    }
  }
  V* yr = y + ((long long)cw[step] * 256 + mc[t_lanes + t]) * kB;
#pragma unroll
  for (int i = 0; i < kB; ++i) atomicAdd(yr + i, acc[i]);
}

template <typename V>
int launch(const V* val, const int* meta, const int* pb, const int* cw,
           const V* x, V* y, int nchunks, int t_lanes, int k_panels,
           int c_batch, void* stream) {
  const long long n = (long long)nchunks * t_lanes;
  if (n > 0) {
    const int threads = 128;
    dense_kernel<V><<<static_cast<unsigned>((n + threads - 1) / threads),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
        val, meta, pb, cw, x, y, nchunks, t_lanes, k_panels, c_batch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_dense(const float* val, const int* meta, const int* pb,
                         const int* cw, const float* x, float* y,
                         int nchunks, int t_lanes, int k_panels,
                         int c_batch, void* stream) {
  return launch(val, meta, pb, cw, x, y, nchunks, t_lanes, k_panels,
                c_batch, stream);
}

extern "C" int tsp_dense_f64(const double* val, const int* meta,
                             const int* pb, const int* cw, const double* x,
                             double* y, int nchunks, int t_lanes,
                             int k_panels, int c_batch, void* stream) {
  return launch(val, meta, pb, cw, x, y, nchunks, t_lanes, k_panels,
                c_batch, stream);
}
