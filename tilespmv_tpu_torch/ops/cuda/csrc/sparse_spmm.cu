// Packed sparse-entry (W-class) SpMM over k right-hand sides for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_sparse_spmm_kernel (called
// by sparse_spmm_call). The tile layout is sparse.cu's: W value slots
// (slot 0 a reserved zero, entries row-sorted), 4-bit columns in meta
// rows 2..2+W/8, row-end bytes in the 4 rows after. Row q of the tile
// sums, for each RHS r < k, slots rend[q-1]+1 .. rend[q] of
// val * X[(tilecol*16 + col)*k + r] into Y[((cw*256 + lrow)*16 + q)*k + r],
// X (rows, k) and Y (ylen, k) row-major; inert lanes (xloc < 0) skip.
//
// Bound: device-memory bytes (~5 bytes per stored entry, read once for
// all k RHS; X through L1/L2). The TPU kernel decoded the nibble columns
// and row pointers once per chunk and redid the x routing, prefix and
// boundary gathers per RHS. Here one thread owns one tile, as in
// sparse.cu: it decodes the row-end bytes once, and each slot's column
// once, and multiplies the slot's value into K register accumulators (K
// a template parameter; X rows read with vector loads, spmm_k.cuh) over
// the row's slot run, with no prefix; each row's K sums are added with
// atomicAdd.
#include <cuda_runtime.h>

#include "spmm_k.cuh"

namespace {

constexpr int kB = 16;
constexpr int kThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
sparse_spmm_kernel(const float* __restrict__ val,
                   const int* __restrict__ meta, const int* __restrict__ pb,
                   const int* __restrict__ cw, const float* __restrict__ x,
                   float* __restrict__ y, int nchunks, int width,
                   int t_lanes, int k_panels, int c_batch) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nchunks * t_lanes) return;
  const int c = static_cast<int>(gid / t_lanes);
  const int t = static_cast<int>(gid % t_lanes);
  const int ncw = width / 8;
  const int mrows = 2 + ncw + 4;
  const int* mc = meta + (long long)c * mrows * t_lanes + t;
  const int xloc = mc[0];
  if (xloc < 0) return;
  const int step = c / c_batch;
  const float* xb =
      x + ((long long)pb[(long long)step * k_panels + (xloc >> 8)] * 256 +
           (xloc & 255)) * kB * K;
  const float* v = val + (long long)c * width * t_lanes + t;
  float* yt = y + ((long long)cw[step] * 256 + mc[t_lanes]) * kB * K;
  unsigned rw[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    rw[u] = static_cast<unsigned>(mc[(long long)(2 + ncw + u) * t_lanes]);
  }
  int s = 1;  // slot 0 is the reserved zero
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const int end = static_cast<int>((rw[q >> 2] >> ((q & 3) * 8)) & 255u);
    if (s > end) continue;
    float acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = 0.f;
    for (; s <= end; ++s) {
      const unsigned word =
          static_cast<unsigned>(mc[(long long)(2 + (s >> 3)) * t_lanes]);
      const int col = static_cast<int>((word >> ((s & 7) * 4)) & 15u);
      tsp::fma_row<K>(v[(long long)s * t_lanes], xb + col * K, acc);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) atomicAdd(yt + q * K + r, acc[r]);
  }
}

}  // namespace

extern "C" int tsp_sparse_spmm(const float* val, const int* meta,
                               const int* pb, const int* cw, const float* x,
                               float* y, int nchunks, int width, int t_lanes,
                               int k_panels, int c_batch, int k_rhs,
                               void* stream) {
  const long long n = (long long)nchunks * t_lanes;
  if (n > 0) {
    const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
      sparse_spmm_kernel<decltype(kc)::value>
          <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
             0, static_cast<cudaStream_t>(stream)>>>(
              val, meta, pb, cw, x, y, nchunks, width, t_lanes, k_panels,
              c_batch);
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
