// Band (brick) class SpMV for sm_90a, f32 and f64.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_band_kernel (called by
// band_class_call; f32 arm, and the df64 arms :545-621 as native FP64):
// y[(cw*256 + t)*16 + i] +=
//   sum_cb sum_j val[w, cb, j, i, t] * x[(tilecol(bloc[t] + cb))*16 + j],
// tilecol(loc) = pb[w*K + (loc >> 8)]*256 + (loc & 255).
//
// Bound: device-memory bytes. The (nchunks, C, 16, 16, 256) brick
// payload is read once at one FMA per value (4 or 8 bytes), far below the
// FP32 and FP64 rates; x (a few MB) stays in L2. Design: one thread per
// output row (window w, lane t, row-in-tile i), so every row of y has
// exactly one writer in the launch and the add needs no atomic (other
// classes add in other, stream-ordered launches). Lanes t are the fastest
// dimension of val, so a warp's loads are 128-byte (f32) or 256-byte (f64)
// coalesced. The TPU emulated f64 with f32 pairs; the f64 instance reads
// the plan's f64 values and accumulates in native FP64.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;   // ROW_WINDOW: tile-rows per window
constexpr int kB = 16;        // tile edge

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename V>
__global__ void band_kernel(const V* __restrict__ val,
                            const int* __restrict__ bloc,
                            const int* __restrict__ pb,
                            const int* __restrict__ cw,
                            const V* __restrict__ x,
                            V* __restrict__ y, int c_cols,
                            int k_panels) {
  const int w = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  const int loc0 = bloc[(long long)w * kLanes + t];
  const int* pbw = pb + (long long)w * k_panels;
  V acc = 0;
  for (int cb = 0; cb < c_cols; ++cb) {
    const int loc = loc0 + cb;
    const V* xb =
        x + ((long long)pbw[loc >> 8] * 256 + (loc & 255)) * kB;
    // val[w][cb][j][i][t]
    const V* v =
        val + (((long long)w * c_cols + cb) * kB * kB + i) * kLanes + t;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      acc = fmadd(v[(long long)j * kB * kLanes], xb[j], acc);
    }
  }
  y[((long long)cw[w] * kLanes + t) * kB + i] += acc;
}

template <typename V>
int launch(const V* val, const int* bloc, const int* pb, const int* cw,
           const V* x, V* y, int nchunks, int c_cols, int k_panels,
           void* stream) {
  if (nchunks > 0) {
    band_kernel<V><<<dim3(nchunks, kB), kLanes, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        val, bloc, pb, cw, x, y, c_cols, k_panels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_band(const float* val, const int* bloc, const int* pb,
                        const int* cw, const float* x, float* y,
                        int nchunks, int c_cols, int k_panels,
                        void* stream) {
  return launch(val, bloc, pb, cw, x, y, nchunks, c_cols, k_panels, stream);
}

extern "C" int tsp_band_f64(const double* val, const int* bloc,
                            const int* pb, const int* cw, const double* x,
                            double* y, int nchunks, int c_cols,
                            int k_panels, void* stream) {
  return launch(val, bloc, pb, cw, x, y, nchunks, c_cols, k_panels, stream);
}
