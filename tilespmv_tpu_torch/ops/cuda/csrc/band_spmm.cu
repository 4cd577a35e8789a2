// Band (brick) class SpMM over k right-hand sides for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_band_spmm_kernel (called by
// band_spmm_call): for each RHS r < k,
//   Y[((cw*256 + t)*16 + i)*k + r] +=
//     sum_cb sum_j val[w, cb, j, i, t] * X[(tilecol(bloc[t] + cb)*16 + j)*k + r],
// tilecol(loc) = pb[w*K + (loc >> 8)]*256 + (loc & 255), with X (rows, k)
// and Y (ylen, k) row-major: band.cu's indices, one RHS per column.
//
// Bound: device-memory bytes. The brick payload is read once for all k
// RHS (the vmapped SpMM would read it k times), at k FMAs per 4 bytes,
// still far below the FP32 rate for k <= 16; the k X values of a row are
// adjacent and stay in L1/L2. Design: band.cu's mapping, one thread per
// output row (window w, lane t, row-in-tile i), so every row of Y has one
// writer in the launch and needs no atomic. Each val element is loaded
// once (coalesced over t) and multiplied into K register accumulators;
// K is a template parameter, and X rows are read with vector loads
// (spmm_k.cuh).
#include <cuda_runtime.h>

#include "spmm_k.cuh"

namespace {

constexpr int kLanes = 256;   // ROW_WINDOW: tile-rows per window
constexpr int kB = 16;        // tile edge

template <int K>
__global__ void __launch_bounds__(kLanes)
band_spmm_kernel(const float* __restrict__ val, const int* __restrict__ bloc,
                 const int* __restrict__ pb, const int* __restrict__ cw,
                 const float* __restrict__ x, float* __restrict__ y,
                 int c_cols, int k_panels) {
  const int w = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  const int loc0 = bloc[(long long)w * kLanes + t];
  const int* pbw = pb + (long long)w * k_panels;
  float acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = 0.f;
  for (int cb = 0; cb < c_cols; ++cb) {
    const int loc = loc0 + cb;
    const float* xb =
        x + ((long long)pbw[loc >> 8] * 256 + (loc & 255)) * kB * K;
    // val[w][cb][j][i][t]
    const float* v =
        val + (((long long)w * c_cols + cb) * kB * kB + i) * kLanes + t;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      tsp::fma_row<K>(v[(long long)j * kB * kLanes], xb + j * K, acc);
    }
  }
  tsp::add_row<K>(y + (((long long)cw[w] * kLanes + t) * kB + i) * K, acc);
}

}  // namespace

extern "C" int tsp_band_spmm(const float* val, const int* bloc,
                             const int* pb, const int* cw, const float* x,
                             float* y, int nchunks, int c_cols, int k_panels,
                             int k_rhs, void* stream) {
  if (nchunks > 0) {
    const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
      band_spmm_kernel<decltype(kc)::value>
          <<<dim3(nchunks, kB), kLanes, 0,
             static_cast<cudaStream_t>(stream)>>>(val, bloc, pb, cw, x, y,
                                                  c_cols, k_panels);
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
