// Packed sparse-entry (W-class) SpMV for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_sparse_kernel (called by
// sparse_class_call, f32 one-hot route). A tile (chunk c, lane t) holds
// W value slots, slot 0 a reserved zero, entries row-sorted; meta rows:
// 0 xloc, 1 window-local tile row, 2..2+W/8 the 4-bit columns (slot s in
// word s/8, nibble s%8), then 4 words of row-end bytes (rend[r] = last
// slot of rows <= r in word r/4, byte r%4). Row r of the tile sums slots
// rend[r-1]+1 .. rend[r] of val * x[tilecol*16 + col], tilecol =
// pb[step*K + (xloc >> 8)]*256 + (xloc & 255); inert lanes (xloc < 0)
// are skipped.
//
// Bound: device-memory bytes (~5 bytes per stored entry plus x reads
// through L1/L2). The TPU formed the row sums as differences of a
// slot prefix computed on the matrix unit; here one thread owns one tile
// and sums each row's slot run directly (no prefix, no shuffle), decoding
// columns and row ends with unsigned shifts, then adds the 16 row sums
// with atomicAdd (tiles of one tile-row can sit in any chunk). Lanes are
// the fastest dimension of val and meta, so a warp's loads coalesce.
#include <cuda_runtime.h>

namespace {

constexpr int kB = 16;

__global__ void sparse_kernel(const float* __restrict__ val,
                              const int* __restrict__ meta,
                              const int* __restrict__ pb,
                              const int* __restrict__ cw,
                              const float* __restrict__ x,
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
           (xloc & 255)) * kB;
  const float* v = val + (long long)c * width * t_lanes + t;
  float* yr = y + ((long long)cw[step] * 256 + mc[t_lanes]) * kB;
  unsigned rw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rw[k] = static_cast<unsigned>(mc[(long long)(2 + ncw + k) * t_lanes]);
  }
  int s = 1;  // slot 0 is the reserved zero
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    const int end = static_cast<int>((rw[r >> 2] >> ((r & 3) * 8)) & 255u);
    if (s > end) continue;
    float acc = 0.f;
    for (; s <= end; ++s) {
      const unsigned word =
          static_cast<unsigned>(mc[(long long)(2 + (s >> 3)) * t_lanes]);
      const int col = static_cast<int>((word >> ((s & 7) * 4)) & 15u);
      acc = fmaf(v[(long long)s * t_lanes], xb[col], acc);
    }
    atomicAdd(yr + r, acc);
  }
}

}  // namespace

extern "C" int tsp_sparse(const float* val, const int* meta, const int* pb,
                          const int* cw, const float* x, float* y,
                          int nchunks, int width, int t_lanes, int k_panels,
                          int c_batch, void* stream) {
  const long long n = (long long)nchunks * t_lanes;
  if (n > 0) {
    const int threads = 128;
    sparse_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                    threads, 0, static_cast<cudaStream_t>(stream)>>>(
        val, meta, pb, cw, x, y, nchunks, width, t_lanes, k_panels,
        c_batch);
  }
  return static_cast<int>(cudaGetLastError());
}
