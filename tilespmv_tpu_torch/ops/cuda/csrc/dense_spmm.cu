// Dense-tile class SpMM over k right-hand sides for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_dense_spmm_kernel (called
// by dense_spmm_call): for chunk c of step c/c_batch, lane t with
// xloc = meta[c, 0, t] >= 0, row-in-tile i and RHS r < k,
//   yc = sum_j val[c, j, i, t] * X[(tilecol*16 + j)*k + r],
//   tilecol = pb[step*K + (xloc >> 8)]*256 + (xloc & 255),
// added to Y[((cw[step]*256 + meta[c, 1, t])*16 + i)*k + r], X (rows, k)
// and Y (ylen, k) row-major. Lanes with xloc < 0 are inert padding.
//
// Bound: device-memory bytes (1 KB of values per tile, read once for all
// k RHS). dense.cu keeps a tile's 16 row sums in one thread; with k RHS
// that would be 16*k registers (256 at k = 16, past the 255 cap). So one
// thread owns one (tile, row i), as band.cu maps its rows: it loads the
// tile's 16 values of row i once (coalesced over t) and multiplies each
// into K register accumulators (K a template parameter; X rows read with
// vector loads, spmm_k.cuh), reading the tile's X rows through L1 (the
// 16 threads of a tile share them). Tiles of one tile-row can sit in any
// chunk, so the K sums are added with atomicAdd.
#include <cuda_runtime.h>

#include "spmm_k.cuh"

namespace {

constexpr int kB = 16;
constexpr int kThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
dense_spmm_kernel(const float* __restrict__ val, const int* __restrict__ meta,
                  const int* __restrict__ pb, const int* __restrict__ cw,
                  const float* __restrict__ x, float* __restrict__ y,
                  int nchunks, int t_lanes, int k_panels, int c_batch) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nchunks * kB * t_lanes) return;
  const int t = static_cast<int>(gid % t_lanes);
  const long long ci = gid / t_lanes;
  const int i = static_cast<int>(ci % kB);
  const int c = static_cast<int>(ci / kB);
  const int* mc = meta + (long long)c * 2 * t_lanes;
  const int xloc = mc[t];
  if (xloc < 0) return;
  const int step = c / c_batch;
  const float* xb =
      x + ((long long)pb[(long long)step * k_panels + (xloc >> 8)] * 256 +
           (xloc & 255)) * kB * K;
  // val[c][j][i][t]
  const float* v = val + ((long long)c * kB * kB + i) * t_lanes + t;
  float acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    tsp::fma_row<K>(v[(long long)j * kB * t_lanes], xb + j * K, acc);
  }
  float* yr =
      y + (((long long)cw[step] * 256 + mc[t_lanes + t]) * kB + i) * K;
#pragma unroll
  for (int r = 0; r < K; ++r) atomicAdd(yr + r, acc[r]);
}

}  // namespace

extern "C" int tsp_dense_spmm(const float* val, const int* meta,
                              const int* pb, const int* cw, const float* x,
                              float* y, int nchunks, int t_lanes,
                              int k_panels, int c_batch, int k_rhs,
                              void* stream) {
  const long long n = (long long)nchunks * kB * t_lanes;
  if (n > 0) {
    const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
      dense_spmm_kernel<decltype(kc)::value>
          <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
             0, static_cast<cudaStream_t>(stream)>>>(
              val, meta, pb, cw, x, y, nchunks, t_lanes, k_panels, c_batch);
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
