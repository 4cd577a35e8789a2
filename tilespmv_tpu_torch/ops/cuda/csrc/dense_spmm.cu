// Dense-tile class SpMM over k right-hand sides for sm_90a, f32 and bf16
// values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_dense_spmm_kernel (called
// by dense_spmm_call): for chunk c of step c/c_batch, lane t with
// xloc = meta[c, 0, t] >= 0, row-in-tile i and RHS r < K,
//   yc = sum_j val[c, j, i, t] * X[(tilecol*16 + j)*K + r],
//   tilecol = pb[step*kp + (xloc >> 8)]*256 + (xloc & 255),
// added to Y[((cw[step]*256 + meta[c, 1, t])*16 + i)*K + r], X (rows, K)
// and Y (ylen, K) row-major. Lanes with xloc < 0 are inert padding.
// Chunk c's meta rows start at meta + c*meta_rows*T: 2 rows a chunk on a
// one-hot plan, 2 + 2*ceil(256/T) on a prefix one, whose boundary rows
// this kernel does not read (every lane routes by its own row 1).
//
// Bound: device-memory bytes (the active tiles' values, 1 KB a tile, read
// once for all K columns; their X blocks and Y rows). The planner pads
// each chunk's lanes at its end (mixed_large: 580 active tiles in 4,096
// lane slots), so the design is dense.cu's walk with K values a row:
// * a block is one group of 32 lanes of one chunk by kWarps of the 16
//   tile rows (grid y covers the rest); warp w holds row i of the 32
//   tiles, so its loads of val[c][j][i][t0 .. t0+31] are coalesced, and a
//   thread keeps its (tile, row)'s K sums in registers;
// * the grid runs only the groups that hold an active lane (`groups`,
//   chunk*T + first lane, derived from meta);
// * each tile's 16-bit nonzero-column mask (`cmask`, derived from val)
//   gates its value loads; a skipped value is its zero, and every product
//   is still taken, so a non-finite X meets 0 as in dense_reference;
// * the group's X blocks (a tile's 16 rows of K floats, contiguous in X,
//   16 KB for 32 tiles at K = 8) are staged once in shared memory with
//   16-byte loads, each thread loading part of its own lane's block;
// * a (tile, row)'s K sums go into Y by vector atomics (sm_90's float4 /
//   float2 atomicAdd in global memory, 4 or 2 columns an atomic where K
//   allows): tiles of one tile row meet across chunks.
// The bf16 instance reads bf16 values (512 B a tile) into the same
// registers as floats; X, Y and the staging are f32 (values.cuh).
// scripts/spmm_probes.py times copies of it over every lane group, with
// every column loaded, with scalar atomics (VEC_ATOMICS 0) and with 4 tile
// rows a block (kWarps 4).
#include <cuda_runtime.h>

#include "spmm_k.cuh"
#include "values.cuh"

// 1: 4 or 2 columns an atomicAdd where K allows (sm_90's float4 / float2
// atomicAdd in global memory); 0: one column each
#define VEC_ATOMICS 1

namespace {

constexpr int kB = 16;       // tile edge
constexpr int kLanes = 32;   // chunk lanes (tiles) of one block: a warp's
constexpr int kWarps = 8;    // tile rows of one block: two 256-thread
                             // blocks per lane group

// floats between two lanes' staged X blocks: 16 rows of K, padded by 4 so
// that each block starts on 16 bytes and neighbouring lanes' float4
// accesses fall in other banks
template <int K>
__host__ __device__ constexpr int xs_stride() {
  return kB * K + 4;
}

// Val: the plan's value type (float or bf16); X, Y and the sums are f32
template <int K, typename Val>
__global__ void __launch_bounds__(kLanes * kWarps)
dense_spmm_kernel(const Val* __restrict__ val, const int* __restrict__ meta,
                  const int* __restrict__ cmask,
                  const int* __restrict__ groups, const int* __restrict__ pb,
                  const int* __restrict__ cw, const float* __restrict__ x,
                  float* __restrict__ y, int t_lanes, int meta_rows,
                  int k_panels, int c_batch) {
  constexpr int XS = xs_stride<K>();
  constexpr int kVec = kB * K / 4;     // float4 of a tile's X block
  __shared__ __align__(16) float xs[kLanes * XS];
  const int g = groups[blockIdx.x];
  const int c = g / t_lanes;
  const int t0 = g - c * t_lanes;
  const int step = c / c_batch;
  const int* mc = meta + (long long)c * meta_rows * t_lanes + t0;
  const int l = threadIdx.x % kLanes;
  const int q = threadIdx.x / kLanes;
  const int i = blockIdx.y * kWarps + q;
  const int xloc = mc[l];
  const bool active = xloc >= 0;
  const unsigned mask = active ? cmask[(long long)c * t_lanes + t0 + l] : 0u;
  // the values first: they do not wait for X
  const Val* v = val + ((long long)c * kB * kB + i) * t_lanes + t0 + l;
  float a[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    a[j] = (mask >> j & 1u) ? tsp::to_acc(v[(long long)j * kB * t_lanes])
                            : 0.f;
  }
  // the lane's X block, kVec float4: float4 q, q + kWarps, ... by the
  // thread of warp q
  if (active) {
    const float4* xb = reinterpret_cast<const float4*>(
        x + ((long long)pb[(long long)step * k_panels + (xloc >> 8)] * 256 +
             (xloc & 255)) * kB * K);
    float4* xl4 = reinterpret_cast<float4*>(xs + l * XS);
#pragma unroll 4
    for (int f = q; f < kVec; f += kWarps) xl4[f] = __ldg(xb + f);
  }
  // the (tile, row)'s Y row, loaded before the barrier
  float* yr = active ? y + (((long long)cw[step] * 256 + mc[t_lanes + l]) *
                                kB + i) * K
                     : nullptr;
  if (!__syncthreads_or(active) || !active) return;
  const float* xl = xs + l * XS;
  float acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kB; ++j) tsp::fma_row<K>(a[j], xl + j * K, acc);
  constexpr int kV = VEC_ATOMICS ? tsp::vec_width<K>() : 1;
  tsp::atomic_add_row<K, kV>(yr, acc);
}

// grid x: the `ngroups` lane groups; grid y: kWarps tile rows a block
template <typename Val>
int launch(const Val* val, const int* meta, const int* cmask,
           const int* groups, int ngroups, const int* pb, const int* cw,
           const float* x, float* y, int t_lanes, int meta_rows,
           int k_panels, int c_batch, int k_rhs, void* stream) {
  if (t_lanes % kLanes || meta_rows < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
    if (ngroups > 0) {
      dense_spmm_kernel<decltype(kc)::value, Val>
          <<<dim3(static_cast<unsigned>(ngroups), kB / kWarps),
             kLanes * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
              val, meta, cmask, groups, pb, cw, x, y, t_lanes, meta_rows,
              k_panels, c_batch);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_dense_spmm(const float* val, const int* meta,
                              const int* cmask, const int* groups,
                              int ngroups, const int* pb, const int* cw,
                              const float* x, float* y, int t_lanes,
                              int meta_rows, int k_panels, int c_batch,
                              int k_rhs, void* stream) {
  return launch(val, meta, cmask, groups, ngroups, pb, cw, x, y, t_lanes,
                meta_rows, k_panels, c_batch, k_rhs, stream);
}

extern "C" int tsp_dense_spmm_bf16(const __nv_bfloat16* val, const int* meta,
                                   const int* cmask, const int* groups,
                                   int ngroups, const int* pb, const int* cw,
                                   const float* x, float* y, int t_lanes,
                                   int meta_rows, int k_panels, int c_batch,
                                   int k_rhs, void* stream) {
  return launch(val, meta, cmask, groups, ngroups, pb, cw, x, y, t_lanes,
                meta_rows, k_panels, c_batch, k_rhs, stream);
}
