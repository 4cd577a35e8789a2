// Dense-tile class SpMV for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_dense_kernel (called by
// dense_class_call, f32 one-hot route): for chunk c of step c/c_batch
// and lane t with xloc = meta[c, 0, t] >= 0,
//   yc[i] = sum_j val[c, j, i, t] * x[tilecol*16 + j],
//   tilecol = pb[step*K + (xloc >> 8)]*256 + (xloc & 255),
// added to y[(cw[step]*256 + meta[c, 1, t])*16 + i]. Lanes with
// xloc < 0 are inert padding and skipped.
//
// Bound: device-memory bytes (1 KB of values per tile, 256 FMAs). The
// TPU routed each chunk to its window by a one-hot matmul; here one
// thread owns one tile (chunk, lane): it loads the tile's 16 x values
// once, keeps 16 row sums in registers, and adds them with atomicAdd,
// because several tiles of one chunk (or of chunks run by other blocks)
// can share a tile-row. Lanes are the fastest dimension of val, so a
// warp's value loads are coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kB = 16;

__global__ void dense_kernel(const float* __restrict__ val,
                             const int* __restrict__ meta,
                             const int* __restrict__ pb,
                             const int* __restrict__ cw,
                             const float* __restrict__ x,
                             float* __restrict__ y, int nchunks,
                             int t_lanes, int k_panels, int c_batch) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nchunks * t_lanes) return;
  const int c = static_cast<int>(gid / t_lanes);
  const int t = static_cast<int>(gid % t_lanes);
  const int* mc = meta + (long long)c * 2 * t_lanes;
  const int xloc = mc[t];
  if (xloc < 0) return;
  const int step = c / c_batch;
  const float* xb =
      x + ((long long)pb[(long long)step * k_panels + (xloc >> 8)] * 256 +
           (xloc & 255)) * kB;
  float xv[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) xv[j] = xb[j];
  // val[c][j][i][t]
  const float* v = val + (long long)c * kB * kB * t_lanes + t;
  float acc[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      acc[i] = fmaf(v[(long long)(j * kB + i) * t_lanes], xv[j], acc[i]);
    }
  }
  float* yr = y + ((long long)cw[step] * 256 + mc[t_lanes + t]) * kB;
#pragma unroll
  for (int i = 0; i < kB; ++i) atomicAdd(yr + i, acc[i]);
}

}  // namespace

extern "C" int tsp_dense(const float* val, const int* meta, const int* pb,
                         const int* cw, const float* x, float* y,
                         int nchunks, int t_lanes, int k_panels,
                         int c_batch, void* stream) {
  const long long n = (long long)nchunks * t_lanes;
  if (n > 0) {
    const int threads = 128;
    dense_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                   threads, 0, static_cast<cudaStream_t>(stream)>>>(
        val, meta, pb, cw, x, y, nchunks, t_lanes, k_panels, c_batch);
  }
  return static_cast<int>(cudaGetLastError());
}
