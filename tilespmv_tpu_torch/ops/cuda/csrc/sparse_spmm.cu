// Packed sparse-entry (W-class) SpMM over k right-hand sides for sm_90a,
// f32 and bf16 values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_sparse_spmm_kernel (called
// by sparse_spmm_call). The tile layout is sparse.cu's: W value slots
// (slot 0 a reserved zero, entries row-sorted), 4-bit columns in meta
// rows 2..2+W/8, row-end bytes in the 4 rows after. Row q of the tile
// sums, for each column c < K, its own slots rend[q-1]+1 .. rend[q] of
// val * X[(tilecol*16 + col)*K + c] into Y[((cw*256 + lrow)*16 + q)*K + c],
// X (rows, K) and Y (ylen, K) row-major; inert lanes (xloc < 0) skip.
// Chunk c's meta rows start at meta + c*meta_rows*T: `meta_rows` is
// 2 + W/8 + 4, and 2*ceil(256/T) more on a prefix plan, whose boundary
// rows this kernel does not read (every lane routes by its own row 1).
//
// Bound: device-memory bytes (~5 bytes per stored entry, read once for
// all K columns; X and Y in L2). The TPU kernel decoded the nibble
// columns and row pointers once per chunk and redid the x routing,
// prefix and boundary gathers per RHS. Design: sparse.cu's, with K
// values per slot:
// * a block is one group of kLanes lanes of a chunk by ceil(W / kSlots)
//   slot groups: thread (q, l) takes slots q*kSlots .. q*kSlots +
//   kSlots-1 of tile l, so its loads of val[c][s][t0 .. t0+kLanes-1] and
//   of the column words are coalesced and independent of each other;
// * the group's X blocks (a tile's 16 rows of K floats, contiguous in X)
//   are staged once in shared memory with 16-B loads, each thread loading
//   part of its own lane's block after xloc and the step's panel ids
//   (loaded side by side): two dependent loads a block;
// * a slot's row is decoded in registers from the tile's row ends (a
//   bytewise compare of the 4 words); slots past rend[15] and inert
//   lanes do no work;
// * a thread sums its slots of one row in K registers and puts them into
//   the block's shared (tile, row) sums when the row changes (a store
//   where no other thread has slots of that row, else atomics);
// * the group's tiles of one tile row (__match_any_sync: a dense matrix
//   row puts thousands of tiles on one tile row) are then summed by the
//   thread of their first lane, and one vector atomicAdd of 4 (or 2)
//   columns goes into Y per (tile row, row) of the group that has
//   entries.
// Shared memory: the X blocks and the sums, kLanes * (32K + 5) floats at
// most (66 KB at K = 16, above the 48 KB a block gets without opting
// in). Each row sums its own slots: a non-finite X reaches only the rows
// whose entries read it, as in the CSR product (ROADMAP.md C).
// The bf16 instance reads bf16 values into the same registers as floats;
// X, Y and the sums are f32 (values.cuh).
// scripts/spmm_probes.py times kSlots, kLanes, atomics for every row's
// sums (kOwnRows 0) and scalar atomics in the flush (VEC_ATOMICS 0).
#include <cuda_runtime.h>

#include "spmm_k.cuh"
#include "values.cuh"

// 1: the flush adds 4 or 2 columns an atomicAdd where K allows (sm_90's
// float4 / float2 atomicAdd in global memory); 0: one column each
#define VEC_ATOMICS 1

namespace {

constexpr int kB = 16;
constexpr int kLanes = 32;     // lanes (tiles) of a block, at most a warp
constexpr int kSlots = 8;      // slots of a thread, a multiple of 8
constexpr int kMaxW = 96;      // the widest class (W_CHOICES)
constexpr int kMaxPanels = 8;  // the most x panels of a step (K_CHOICES)
constexpr int kOwnRows = 1;    // 0: every row's sums go in by atomics
constexpr int kMaxThreads = kLanes * ((kMaxW + kSlots - 1) / kSlots);
constexpr unsigned kLaneMask =
    kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1u;

// floats between two lanes' staged X blocks: 16 rows of K, padded by the
// row's vector width, so that neighbouring lanes' vector loads fall in
// other banks
template <int K>
__host__ __device__ constexpr int xs_stride() {
  return kB * K + tsp::vec_width<K>();
}

// floats between two lanes' sums: 16 rows of K, made odd
template <int K>
__host__ __device__ constexpr int ys_stride() {
  return kB * K + 1;
}

template <int K>
__host__ __device__ constexpr int smem_bytes() {
  return kLanes * (xs_stride<K>() + ys_stride<K>()) * 4;
}

__device__ __forceinline__ int rend_byte(const unsigned* rw, int r) {
  return static_cast<int>(rw[r >> 2] >> ((r & 3) * 8) & 255u);
}

// rend_byte for a row known only at run time (rw stays in registers)
__device__ __forceinline__ int rend_at(const unsigned* rw, int r) {
  const unsigned w = r < 8 ? (r < 4 ? rw[0] : rw[1])
                           : (r < 12 ? rw[2] : rw[3]);
  return static_cast<int>(w >> ((r & 3) * 8) & 255u);
}

// p[0..3] = a, p aligned to the vector width of K
template <int K>
__device__ __forceinline__ void store4(float* p, float4 a) {
  if constexpr (tsp::vec_width<K>() == 4) {
    *reinterpret_cast<float4*>(p) = a;
  } else if constexpr (tsp::vec_width<K>() == 2) {
    reinterpret_cast<float2*>(p)[0] = make_float2(a.x, a.y);
    reinterpret_cast<float2*>(p)[1] = make_float2(a.z, a.w);
  } else {
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
  }
}

// Val: the plan's value type (float or bf16); X, Y and the sums are f32
template <int K, typename Val>
__global__ void __launch_bounds__(kMaxThreads)
sparse_spmm_kernel(const Val* __restrict__ val,
                   const int* __restrict__ meta, const int* __restrict__ pb,
                   const int* __restrict__ cw, const float* __restrict__ x,
                   float* __restrict__ y, int width, int t_lanes,
                   int meta_rows, int k_panels, int c_batch) {
  constexpr int XS = xs_stride<K>();
  constexpr int YS = ys_stride<K>();
  constexpr int kTile = kB * K;      // floats of a tile's X block or sums
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);   // kLanes X blocks
  float* ys = xs + kLanes * XS;                 // kLanes x 16 rows of sums
  __shared__ int srow[kLanes];        // window-local tile row, -1 inert
  __shared__ int slead[kLanes];       // first lane of the same tile row
  __shared__ unsigned sfoll[kLanes];  // the lanes of that tile row
  __shared__ unsigned smask[kLanes];  // a leader's rows with entries
  const int ngroups = t_lanes / kLanes;
  const int c = blockIdx.x / ngroups;
  const int t0 = (blockIdx.x - c * ngroups) * kLanes;
  const int step = c / c_batch;
  const int ncw = width / 8;
  const int* mc = meta + (long long)c * meta_rows * t_lanes + t0;
  const int l = threadIdx.x % kLanes;
  const int q = threadIdx.x / kLanes;
  const int s0 = q * kSlots;
  const int xloc = mc[l];
  const bool active = xloc >= 0;
  // the step's panel ids, loaded beside xloc: the X block waits for one
  // load, not two
  const int* pbs = pb + (long long)step * k_panels;
  int pbk[kMaxPanels];
#pragma unroll
  for (int k = 0; k < kMaxPanels; ++k) pbk[k] = k < k_panels ? pbs[k] : 0;
  unsigned rw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rw[k] =
        static_cast<unsigned>(mc[(long long)(2 + ncw + k) * t_lanes + l]);
  }
  const int last = active ? rend_byte(rw, kB - 1) : 0;
  // the thread's column words and values: they do not wait for X
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
  // the lane's X block, 4K float4: float4 q, q + groups, ... by the
  // thread of slot group q
  const int groups = blockDim.x / kLanes;
  if (active) {
    int panel = pbk[0];
#pragma unroll
    for (int k = 1; k < kMaxPanels; ++k) {
      if (xloc >> 8 == k) panel = pbk[k];
    }
    const float4* xb = reinterpret_cast<const float4*>(
        x + ((long long)panel * 256 + (xloc & 255)) * kTile);
    float* xl = xs + l * XS;
#pragma unroll 4
    for (int i = q; i < kTile / 4; i += groups) {
      store4<K>(xl + 4 * i, __ldg(xb + i));
    }
  }
  for (int e = threadIdx.x; e < kLanes * YS; e += blockDim.x) ys[e] = 0.f;
  if (threadIdx.x < kLanes) {
    // the lanes of one tile row add through their first lane
    const int tr = active ? mc[t_lanes + l] : -1;
    const unsigned same = __match_any_sync(kLaneMask, active ? tr : -1 - l);
    const int lead = __ffs(same) - 1;
    unsigned rows = 0;
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      rows |= static_cast<unsigned>(
          rend_byte(rw, r) > (r > 0 ? rend_byte(rw, r - 1) : 0)) << r;
    }
    srow[l] = tr;
    slead[l] = lead;
    sfoll[l] = same;
    smask[l] = 0u;
    __syncwarp(kLaneMask);
    if (active) atomicOr(&smask[lead], rows);
  }
  if (!__syncthreads_or(active)) return;
  // the thread's slots, row by row
  const float* xl = xs + l * XS;
  float* yl = ys + l * YS;
  int row = -1;
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
  // a row whose slots all lie among the thread's is its alone: its sums
  // are stored; the others' (shared with the next slot groups) added by
  // shared-memory atomics, which are compare-and-swap loops for floats
  auto put = [&](int r) {
    const int lo = r > 0 ? rend_at(rw, r - 1) : 0;
    if (kOwnRows && lo + 1 >= s0 && rend_at(rw, r) < s0 + kSlots) {
#pragma unroll
      for (int j = 0; j < K; ++j) yl[r * K + j] = acc[j];
    } else {
      tsp::atomic_add_row<K>(yl + r * K, acc);
    }
  };
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
      if (row >= 0) put(row);
      row = r;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = 0.f;
    }
    const int col = static_cast<int>(cols[k / 8] >> ((s & 7) * 4) & 15u);
    tsp::fma_row<K>(v[k], xl + col * K, acc);
  }
  if (row >= 0) put(row);
  __syncthreads();
  // per (tile row, row) of the group with entries and vector of columns
  // (sm_90's vector atomics take kV columns at once): the sums of the
  // tile row's lanes, added up by the thread of its leader, then one
  // atomicAdd into Y
  constexpr int kV = VEC_ATOMICS ? tsp::vec_width<K>() : 1;
  float* yw = y + (long long)cw[step] * 256 * kTile;
  for (int e = threadIdx.x; e < kLanes * kTile / kV; e += blockDim.x) {
    const int lane = e / (kTile / kV);
    const int i = (e - lane * (kTile / kV)) * kV;
    if (srow[lane] >= 0 && slead[lane] == lane &&
        (smask[lane] >> (i / K) & 1u)) {
      float w[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) w[j] = ys[lane * YS + i + j];
      for (unsigned m = sfoll[lane] & (sfoll[lane] - 1); m; m &= m - 1) {
        const float* o = ys + (__ffs(m) - 1) * YS + i;
#pragma unroll
        for (int j = 0; j < kV; ++j) w[j] += o[j];
      }
      tsp::atomic_add_nonzero<kV>(yw + srow[lane] * kTile + i, w);
    }
  }
}

template <typename Val>
int launch(const Val* val, const int* meta, const int* pb, const int* cw,
           const float* x, float* y, int nchunks, int width, int t_lanes,
           int meta_rows, int k_panels, int c_batch, int k_rhs,
           void* stream) {
  if (width < 8 || width > kMaxW || width % 8 || t_lanes % kLanes ||
      meta_rows < 2 + width / 8 + 4 || k_panels < 1 ||
      k_panels > kMaxPanels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = static_cast<int>(cudaSuccess);
  const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    static const cudaError_t attr = cudaFuncSetAttribute(
        sparse_spmm_kernel<K, Val>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<K>());
    if (attr != cudaSuccess) {
      err = static_cast<int>(attr);
    } else if (nchunks > 0) {
      const int groups = (width + kSlots - 1) / kSlots;
      sparse_spmm_kernel<K, Val>
          <<<nchunks * (t_lanes / kLanes), kLanes * groups, smem_bytes<K>(),
             static_cast<cudaStream_t>(stream)>>>(
          val, meta, pb, cw, x, y, width, t_lanes, meta_rows, k_panels,
          c_batch);
      err = static_cast<int>(cudaGetLastError());
    }
  });
  return ok ? err : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tsp_sparse_spmm(const float* val, const int* meta,
                               const int* pb, const int* cw, const float* x,
                               float* y, int nchunks, int width, int t_lanes,
                               int meta_rows, int k_panels, int c_batch,
                               int k_rhs, void* stream) {
  return launch(val, meta, pb, cw, x, y, nchunks, width, t_lanes,
                meta_rows, k_panels, c_batch, k_rhs, stream);
}

extern "C" int tsp_sparse_spmm_bf16(const __nv_bfloat16* val, const int* meta,
                                    const int* pb, const int* cw,
                                    const float* x, float* y, int nchunks,
                                    int width, int t_lanes, int meta_rows,
                                    int k_panels, int c_batch, int k_rhs,
                                    void* stream) {
  return launch(val, meta, pb, cw, x, y, nchunks, width, t_lanes,
                meta_rows, k_panels, c_batch, k_rhs, stream);
}
