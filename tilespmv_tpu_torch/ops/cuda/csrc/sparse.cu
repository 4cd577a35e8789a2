// Packed sparse-entry (W-class) SpMV for sm_90a, f32 and bf16 values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_sparse_kernel (called by
// sparse_class_call, f32 one-hot route). A tile (chunk c, lane t) holds
// W value slots, slot 0 a reserved zero, entries row-sorted; meta rows:
// 0 xloc, 1 window-local tile row, 2..2+W/8 the 4-bit columns (slot s in
// word s/8, nibble s%8), then 4 words of row-end bytes (rend[r] = last
// slot of rows <= r in word r/4, byte r%4). Row r of the tile sums slots
// rend[r-1]+1 .. rend[r] of val * x[tilecol*16 + col], tilecol =
// pb[step*K + (xloc >> 8)]*256 + (xloc & 255); inert lanes (xloc < 0)
// are skipped. A chunk holds `meta_rows` meta rows: 2 + W/8 + 4 on a
// one-hot plan, 2*ceil(256/T) more on a prefix one (its boundary rows,
// which this kernel does not read: every lane routes by its own row 1),
// so chunk c's rows start at meta + c*meta_rows*T.
//
// Bound: device-memory bytes (~5 bytes per stored entry, x and y in L2).
// At 16-80 entries a tile, a thread per tile would walk a chain of
// dependent loads and FMAs as long as its tile, on a few thousand
// threads. Design:
// * a block is one group of 32 lanes of a chunk by ceil(W / kSlots)
//   warps; warp q takes slots q*kSlots .. q*kSlots + kSlots-1 of the 32
//   tiles (whole meta column words), so its loads of val[c][s][t0 ..
//   t0+31] and of the words are coalesced and independent of each other;
// * the group's x blocks (32 x 16 values) are staged once in shared
//   memory, each thread loading its own lane's columns q, q + warps, ...
//   together, after xloc and the step's K panel ids (loaded side by
//   side): two dependent loads a block;
// * a slot's row is decoded in registers from the tile's row ends: the
//   count of rows r with rend[r] < s (a bytewise compare of the 4 words);
//   slots past rend[15] and inert lanes do no work;
// * a thread sums its slots of one row in a register and adds the sum
//   into the block's shared (tile, row) sums when the row changes; the
//   group's tiles of one tile row then add theirs into those of its first
//   lane (__match_any_sync), and one atomicAdd goes into y per (tile row,
//   row) of the group that has entries, 16 neighbouring threads adding a
//   tile's 16 rows (tiles of one tile row can sit in any chunk, and a
//   dense matrix row puts thousands of tiles on one tile row, whose
//   atomics would queue on its 16 addresses).
// Each row sums its own slots: a non-finite x reaches only the rows whose
// entries read it, as in the CSR product (the TPU's differences of a
// prefix over every slot put NaN in other rows of the tile; ROADMAP.md C).
// The bf16 instance reads bf16 values (~3 bytes per stored entry) and
// computes as the f32 one, on f32 x and y (values.cuh).
// scripts/sparse_probes.py times kSlots in {8, 16, 32}, one atomic per
// (tile, row), and copies with parts of the work taken out.
#include <cuda_runtime.h>

#include "values.cuh"

namespace {

constexpr int kB = 16;
constexpr int kPad = kB + 1;   // staged row stride: no bank conflicts
constexpr int kLanes = 32;     // lanes (tiles) of a block: a warp's
constexpr int kSlots = 8;      // slots of a thread, a multiple of 8
constexpr int kMaxW = 96;      // the widest class (W_CHOICES)
constexpr int kMaxK = 8;       // the most x panels of a step (K_CHOICES)
constexpr int kMaxWarps = (kMaxW + kSlots - 1) / kSlots;

__device__ __forceinline__ int rend_byte(const unsigned* rw, int r) {
  return static_cast<int>(rw[r >> 2] >> ((r & 3) * 8) & 255u);
}

// Val: the plan's value type (float or bf16); x, y and the sums are f32
template <typename Val>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
sparse_kernel(const Val* __restrict__ val, const int* __restrict__ meta,
              const int* __restrict__ pb, const int* __restrict__ cw,
              const float* __restrict__ x, float* __restrict__ y,
              int width, int t_lanes, int meta_rows, int k_panels,
              int c_batch) {
  __shared__ float xs[kLanes * kPad];
  __shared__ float ys[kLanes * kPad];
  __shared__ int srow[kLanes];        // window-local tile row, -1 inert
  __shared__ int slead[kLanes];       // first lane of the same tile row
  __shared__ unsigned smask[kLanes];  // a leader's rows with entries
  const int ngroups = t_lanes / kLanes;
  const int c = blockIdx.x / ngroups;
  const int t0 = (blockIdx.x - c * ngroups) * kLanes;
  const int step = c / c_batch;
  const int ncw = width / 8;
  const int* mc = meta + (long long)c * meta_rows * t_lanes + t0;
  const int l = threadIdx.x % kLanes;
  const int s0 = threadIdx.x / kLanes * kSlots;
  const int xloc = mc[l];
  const bool active = xloc >= 0;
  // the step's panel ids, loaded beside xloc: the x block waits for one
  // load, not two
  const int* pbs = pb + (long long)step * k_panels;
  int pbk[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) pbk[k] = k < k_panels ? pbs[k] : 0;
  unsigned rw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rw[k] =
        static_cast<unsigned>(mc[(long long)(2 + ncw + k) * t_lanes + l]);
  }
  const int last = active ? rend_byte(rw, kB - 1) : 0;
  // the thread's column words and values: they do not wait for x
  unsigned cols[kSlots / 8];
  float v[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots / 8; ++u) {
    const int s = s0 + u * 8;
    cols[u] = s <= last && s < width
        ? static_cast<unsigned>(mc[(long long)(2 + s / 8) * t_lanes + l])
        : 0u;
  }
  const Val* vc = val + (long long)c * width * t_lanes + t0 + l;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = s0 + k;
    v[k] = s >= 1 && s <= last ? tsp::to_acc(vc[(long long)s * t_lanes])
                               : 0.f;
  }
  // the lane's x block, columns q, q + warps, ... by warp q, all of a
  // thread's columns in flight
  const int warps = blockDim.x / kLanes;
  const int q = threadIdx.x / kLanes;
  if (active) {
    int panel = pbk[0];
#pragma unroll
    for (int k = 1; k < kMaxK; ++k) {
      if (xloc >> 8 == k) panel = pbk[k];
    }
    const float* xb = x + ((long long)panel * 256 + (xloc & 255)) * kB;
    float xv[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (q + u * warps < kB) xv[u] = xb[q + u * warps];
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (q + u * warps < kB) xs[l * kPad + q + u * warps] = xv[u];
    }
  }
  for (int e = threadIdx.x; e < kLanes * kB; e += blockDim.x) {
    ys[e / kB * kPad + e % kB] = 0.f;
  }
  if (threadIdx.x < kLanes) {
    // the lanes of one tile row add through their first lane (a tile row
    // can fill a group: a dense matrix row has a tile in every column)
    const int tr = active ? mc[t_lanes + l] : -1;
    const int lead =
        __ffs(__match_any_sync(0xffffffffu, active ? tr : -1 - l)) - 1;
    unsigned rows = 0;
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      rows |= static_cast<unsigned>(
          rend_byte(rw, r) > (r > 0 ? rend_byte(rw, r - 1) : 0)) << r;
    }
    srow[l] = tr;
    slead[l] = lead;
    smask[l] = 0u;
    __syncwarp();
    if (active) atomicOr(&smask[lead], rows);
  }
  if (!__syncthreads_or(active)) return;
  // the thread's slots, row by row
  const float* xl = xs + l * kPad;
  float* yl = ys + l * kPad;
  int row = -1;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = s0 + k;
    if (s < 1 || s > last) continue;
    const unsigned sb = static_cast<unsigned>(s) * 0x01010101u;
    const int r = (__popc(__vcmpltu4(rw[0], sb))
                   + __popc(__vcmpltu4(rw[1], sb))
                   + __popc(__vcmpltu4(rw[2], sb))
                   + __popc(__vcmpltu4(rw[3], sb))) >> 3;
    if (r != row) {
      if (row >= 0) atomicAdd(yl + row, acc);
      row = r;
      acc = 0.f;
    }
    const int col = static_cast<int>(cols[k / 8] >> ((s & 7) * 4) & 15u);
    acc = fmaf(v[k], xl[col], acc);
  }
  if (row >= 0) atomicAdd(yl + row, acc);
  __syncthreads();
  // each lane's row sums into its leader's (an empty row adds its 0)
  for (int e = threadIdx.x; e < kLanes * kB; e += blockDim.x) {
    const int lane = e / kB;
    if (srow[lane] >= 0 && slead[lane] != lane) {
      atomicAdd(&ys[slead[lane] * kPad + e % kB], ys[lane * kPad + e % kB]);
    }
  }
  __syncthreads();
  // one atomicAdd per (tile row, row) of the group with entries
  float* yw = y + (long long)cw[step] * 256 * kB;
  for (int e = threadIdx.x; e < kLanes * kB; e += blockDim.x) {
    const int lane = e / kB;
    const int r = e % kB;
    if (srow[lane] >= 0 && slead[lane] == lane && (smask[lane] >> r & 1u)) {
      atomicAdd(yw + srow[lane] * kB + r, ys[lane * kPad + r]);
    }
  }
}

template <typename Val>
int launch(const Val* val, const int* meta, const int* pb, const int* cw,
           const float* x, float* y, int nchunks, int width, int t_lanes,
           int meta_rows, int k_panels, int c_batch, void* stream) {
  if (width < 8 || width > kMaxW || width % 8 || t_lanes % kLanes ||
      meta_rows < 2 + width / 8 + 4 || k_panels < 1 || k_panels > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    const int warps = (width + kSlots - 1) / kSlots;
    sparse_kernel<Val><<<nchunks * (t_lanes / kLanes), kLanes * warps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        val, meta, pb, cw, x, y, width, t_lanes, meta_rows, k_panels,
        c_batch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_sparse(const float* val, const int* meta, const int* pb,
                          const int* cw, const float* x, float* y,
                          int nchunks, int width, int t_lanes,
                          int meta_rows, int k_panels, int c_batch,
                          void* stream) {
  return launch(val, meta, pb, cw, x, y, nchunks, width, t_lanes,
                meta_rows, k_panels, c_batch, stream);
}

extern "C" int tsp_sparse_bf16(const __nv_bfloat16* val, const int* meta,
                               const int* pb, const int* cw, const float* x,
                               float* y, int nchunks, int width, int t_lanes,
                               int meta_rows, int k_panels, int c_batch,
                               void* stream) {
  return launch(val, meta, pb, cw, x, y, nchunks, width, t_lanes,
                meta_rows, k_panels, c_batch, stream);
}
