// Band (brick) class SpMV for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_band_kernel (called by
// band_class_call): y[(cw*256 + t)*16 + i] +=
//   sum_cb sum_j val[w, cb, j, i, t] * x[(tilecol(bloc[t] + cb))*16 + j],
// tilecol(loc) = pb[w*K + (loc >> 8)]*256 + (loc & 255).
//
// Bound: device-memory bytes. The (nchunks, C, 16, 16, 256) f32 brick
// payload is read once at one FMA per 4 bytes, far below the FP32 rate;
// x (a few MB) stays in L2. Design: one thread per output row (window w,
// lane t, row-in-tile i), so every row of y has exactly one writer in
// the launch and the add needs no atomic (other classes add in other,
// stream-ordered launches). Lanes t are the fastest dimension of val, so
// a warp's loads are 128-byte coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;   // ROW_WINDOW: tile-rows per window
constexpr int kB = 16;        // tile edge

__global__ void band_kernel(const float* __restrict__ val,
                            const int* __restrict__ bloc,
                            const int* __restrict__ pb,
                            const int* __restrict__ cw,
                            const float* __restrict__ x,
                            float* __restrict__ y, int c_cols,
                            int k_panels) {
  const int w = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  const int loc0 = bloc[(long long)w * kLanes + t];
  const int* pbw = pb + (long long)w * k_panels;
  float acc = 0.f;
  for (int cb = 0; cb < c_cols; ++cb) {
    const int loc = loc0 + cb;
    const float* xb =
        x + ((long long)pbw[loc >> 8] * 256 + (loc & 255)) * kB;
    // val[w][cb][j][i][t]
    const float* v =
        val + (((long long)w * c_cols + cb) * kB * kB + i) * kLanes + t;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      acc = fmaf(v[(long long)j * kB * kLanes], xb[j], acc);
    }
  }
  y[((long long)cw[w] * kLanes + t) * kB + i] += acc;
}

}  // namespace

extern "C" int tsp_band(const float* val, const int* bloc, const int* pb,
                        const int* cw, const float* x, float* y,
                        int nchunks, int c_cols, int k_panels,
                        void* stream) {
  if (nchunks > 0) {
    band_kernel<<<dim3(nchunks, kB), kLanes, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        val, bloc, pb, cw, x, y, c_cols, k_panels);
  }
  return static_cast<int>(cudaGetLastError());
}
