// Entry-stream (COO-tile) class over k right-hand sides for sm_90a, f32 and
// bf16 values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_stream_kernel2 (called by
// stream_class_call2, one RHS pair a call): it computes what that kernel
// computes for every pair of columns at once. Per slab si, entry (k, l)
// with vidx v and erow r >= 0 adds, for each column c < K,
//   val * X[(row*128 + (v & 127))*ld + c] into Y[(cw[step]*1024 + r)*ld + c],
// with stream.cu's row (sbase, or sbase2 when bit 13 of v is set, for
// span slabs; xmap[si*64 + ((v >> 7) & 7)*8 + k] for free-placement
// slabs); X and Y row-major with rows of ld floats (the wrapper's ld is
// K); r = -1 marks lane 0 and padding.
//
// Bound: device-memory bytes, 8 B per slot (4 B value, 2 B vidx, 2 B
// erow) read once for all K columns; X (a few MB) is gathered from L2,
// one 32-B sector per entry at K = 8. The TPU kernel took one RHS pair a
// call (its register limit) and routed the sums through int8 round
// planes, so a matmat over k columns read the plan and the planes k/2
// times. Design: stream.cu's, with K values per lane, one launch per
// class for all K columns and the planes not read:
// * a block of 256 threads takes `group` consecutive slabs of one step
//   (grid nsteps * ceil(S / group)); warp k reads sublane k, 4
//   consecutive lanes a thread (fewer where 4*K would pass kProducts),
//   each lane gathering its X row of K floats with vector loads
//   (spmm_k.cuh);
// * erow is non-decreasing along a sublane's entries, so a segmented
//   inclusive scan keyed on it (in registers, then across the warp by
//   shuffles, K values a step) sums each run of one row;
// * the run's last lane adds its K sums straight into Y by sm_90's
//   vector atomics (4 or 2 columns each, red.global at L2). stream.cu's
//   shared window (kWindowed 1: the runs add into 1024 rows of K floats
//   in shared memory, then the window into Y) costs 1.5x here: float
//   atomics in shared memory are compare-and-swap loops, and a run is
//   mostly one entry long, so there are K of them per entry.
// Steps whose slabs are all padding (sactive = 0) return at once; a
// warp's lanes with no entry skip their value loads and gathers. The bf16
// instance reads 6 B a slot, its values widened to f32 as they are
// loaded; X, Y and the sums are f32 (values.cuh).
// scripts/spmm_probes.py times kScan 0 (no warp scan: each thread's runs
// add into Y), kWindowed 1, kProducts, scalar atomics (VEC_ATOMICS 0),
// kMinBlocks, the group and k/2 launches at K = 2 (PERF.md).
#include <cuda_runtime.h>

#include "spmm_k.cuh"
#include "values.cuh"

// 1: the adds into Y take 4 or 2 columns an atomicAdd where K and ld
// allow (sm_90's float4 / float2 atomicAdd in global memory); 0: one
#define VEC_ATOMICS 1

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWindow = kSubs * kLanes;
constexpr int kProducts = 64;  // most lanes * K products a thread holds
constexpr int kScan = 1;       // 0: each thread's runs add on their own
constexpr int kMinBlocks = 1;  // resident blocks an SM the registers allow
constexpr int kWindowed = 0;   // 1: runs add into a shared window first
constexpr unsigned kFull = 0xffffffffu;

// lanes a thread takes at K: 4, 2 or 1
template <int K>
__host__ __device__ constexpr int lanes_per_thread() {
  return kProducts / K >= 4 ? 4 : kProducts / K >= 2 ? 2 : 1;
}

// floats between two window rows: K, made odd
template <int K>
__host__ __device__ constexpr int win_stride() {
  return K | 1;
}

template <int L>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[L]) {
  if constexpr (L == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (L == 2) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldcs(p);
  }
}

// L bf16 as floats from one load
template <int L>
__device__ __forceinline__ void load_lanes(const __nv_bfloat16* p,
                                           float (&v)[L]) {
  if constexpr (L == 4) {
    const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo = tsp::bf16x2_to_float2(a.x);
    const float2 hi = tsp::bf16x2_to_float2(a.y);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else if constexpr (L == 2) {
    const float2 a =
        tsp::bf16x2_to_float2(__ldcs(reinterpret_cast<const unsigned*>(p)));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __uint_as_float(
        static_cast<unsigned>(
            __ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
}

// L int16 as ints (sign-extended) from one load
template <int L>
__device__ __forceinline__ void load_lanes(const short* p, int (&v)[L]) {
  if constexpr (L == 4) {
    const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = static_cast<short>(a.x & 0xffffu);
    v[1] = static_cast<short>(a.x >> 16);
    v[2] = static_cast<short>(a.y & 0xffffu);
    v[3] = static_cast<short>(a.y >> 16);
  } else if constexpr (L == 2) {
    const unsigned a = __ldcs(reinterpret_cast<const unsigned*>(p));
    v[0] = static_cast<short>(a & 0xffffu);
    v[1] = static_cast<short>(a >> 16);
  } else {
    v[0] = __ldcs(p);
  }
}

// Val: the plan's value type (float or bf16); X, Y and the sums are f32
template <int K, typename Val>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stream_spmm_kernel(const Val* __restrict__ val,
                   const short* __restrict__ vidx,
                   const short* __restrict__ erow,
                   const int* __restrict__ sbase,
                   const int* __restrict__ sbase2,
                   const int* __restrict__ xmap, const int* __restrict__ cw,
                   const int* __restrict__ sactive,
                   const float* __restrict__ x, float* __restrict__ y,
                   int s_batch, int group, int groups_per_step,
                   int span_rows, int ld) {
  constexpr int L = lanes_per_thread<K>();
  constexpr int RS = win_stride<K>();
  // sm_90's vector atomics take kV columns at once
  constexpr int kV = VEC_ATOMICS ? tsp::vec_width<K>() : 1;
  const int step = blockIdx.x / groups_per_step;
  if (sactive[step] == 0) return;
  const int g0 = (blockIdx.x - step * groups_per_step) * group;
  const int g1 = min(g0 + group, s_batch);
  extern __shared__ float win[];     // kWindow rows of RS floats
  const int tid = threadIdx.x;
  float* yw = y + (long long)cw[step] * kWindow * ld;
  if constexpr (kWindowed != 0) {
    for (int i = tid; i < kWindow * RS; i += kThreads) win[i] = 0.f;
    __syncthreads();
  }

  const int k = tid >> 5;            // sublane this warp reads
  const int lane_id = tid & 31;
  const int rows_per_sub = span_rows / 8;
  for (int s = g0; s < g1; ++s) {
    const long long si = (long long)step * s_batch + s;
#pragma unroll 1
    for (int l0 = lane_id * L; l0 < kLanes; l0 += 32 * L) {
      const long long e0 = (si * kSubs + k) * kLanes + l0;
      int r[L];
      load_lanes<L>(erow + e0, r);
      int rmax = r[0];
#pragma unroll
      for (int u = 1; u < L; ++u) rmax = max(rmax, r[u]);
      if (!__any_sync(kFull, rmax >= 0)) continue;  // no entry here
      float v[L];
      int ci[L];
      load_lanes<L>(val + e0, v);
      load_lanes<L>(vidx + e0, ci);
      int sb = 0, sb2 = 0;
      if (xmap == nullptr) {
        sb = sbase[si];
        sb2 = sbase2[si];
      }
      float c[L][K];
#pragma unroll
      for (int u = 0; u < L; ++u) {
#pragma unroll
        for (int j = 0; j < K; ++j) c[u][j] = 0.f;
        if (r[u] >= 0) {
          const unsigned cv = static_cast<unsigned>(ci[u]) & 0xffffu;
          const int ch = static_cast<int>((cv >> 7) & (rows_per_sub - 1));
          long long row;
          if (xmap != nullptr) {
            row = xmap[si * 64 + ch * kSubs + k];
          } else {
            row = (long long)(((cv >> 13) & 1u) ? sb2 : sb) +
                  k * rows_per_sub + ch;
          }
          tsp::fma_row<K>(v[u], x + (row * kLanes + (cv & 127u)) * ld,
                          c[u]);
        }
      }
      // segmented inclusive sums within the thread's L lanes
#pragma unroll
      for (int u = 1; u < L; ++u) {
        if (r[u] == r[u - 1]) {
#pragma unroll
          for (int j = 0; j < K; ++j) c[u][j] += c[u - 1][j];
        }
      }
      const int next_r0 = __shfl_down_sync(kFull, r[0], 1);
      if constexpr (kScan != 0) {
        const int prev_r = __shfl_up_sync(kFull, r[L - 1], 1);
        bool whole = true;
#pragma unroll
        for (int u = 1; u < L; ++u) whole = whole && r[u] == r[0];
        // (head, tot): does the thread's last run start in it, and that
        // run's K sums so far; scanned across the warp
        int head = !(whole && lane_id > 0 && prev_r == r[L - 1]);
        float tot[K];
#pragma unroll
        for (int j = 0; j < K; ++j) tot[j] = c[L - 1][j];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int nh = __shfl_up_sync(kFull, head, off);
          float nt[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            nt[j] = __shfl_up_sync(kFull, tot[j], off);
          }
          if (lane_id >= off) {
            if (!head) {
#pragma unroll
              for (int j = 0; j < K; ++j) tot[j] += nt[j];
            }
            head |= nh;
          }
        }
        // the run the previous thread ended in, if it goes on here
        float cin[K];
#pragma unroll
        for (int j = 0; j < K; ++j) cin[j] = __shfl_up_sync(kFull, tot[j], 1);
        const bool carry = lane_id > 0 && prev_r == r[0];
        bool lead = true;
#pragma unroll
        for (int u = 0; u < L; ++u) {
          lead = lead && r[u] == r[0];
          if (carry && lead) {
#pragma unroll
            for (int j = 0; j < K; ++j) c[u][j] += cin[j];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const bool end = u < L - 1 ? r[u] != r[u + 1]
                                   : (kScan == 0 || lane_id == 31 ||
                                      next_r0 != r[L - 1]);
        if (end && r[u] >= 0) {
          if constexpr (kWindowed != 0) {
            tsp::atomic_add_row<K>(win + r[u] * RS, c[u]);
          } else {
            tsp::atomic_add_row<K, kV>(yw + (long long)r[u] * ld, c[u]);
          }
        }
      }
    }
  }
  if constexpr (kWindowed == 0) return;
  // the window into Y, one atomicAdd a row and vector of columns that
  // holds a nonzero: the window's other groups and steps run in other
  // blocks
  __syncthreads();
  for (int i = tid; i < kWindow * (K / kV); i += kThreads) {
    const int row = i / (K / kV);
    const int j = (i - row * (K / kV)) * kV;
    tsp::atomic_add_nonzero<kV>(yw + (long long)row * ld + j,
                                win + row * RS + j);
  }
}

// bytes of the shared window
template <int K>
__host__ __device__ constexpr int win_bytes() {
  return kWindowed ? kWindow * win_stride<K>() * 4 : 0;
}

template <int K, typename Val>
int launch(const Val* val, const short* vidx, const short* erow,
           const int* sbase, const int* sbase2, const int* xmap,
           const int* cw, const int* sactive, const float* x, float* y,
           int nsteps, int s_batch, int span_rows, int group, int gps,
           int ld, cudaStream_t stream) {
  constexpr int bytes = win_bytes<K>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      stream_spmm_kernel<K, Val>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  stream_spmm_kernel<K, Val><<<nsteps * gps, kThreads, bytes, stream>>>(
      val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y, s_batch,
      group, gps, span_rows, ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename Val>
int launch_k(const Val* val, const short* vidx, const short* erow,
             const int* sbase, const int* sbase2, const int* xmap,
             const int* cw, const int* sactive, const float* x, float* y,
             int nsteps, int s_batch, int span_rows, int group, int k_rhs,
             int ld, void* stream) {
  const int gps = group > 0 ? (s_batch + group - 1) / group : 0;
  if (gps < 1 || ld < k_rhs || (long long)nsteps * gps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = static_cast<int>(cudaSuccess);
  const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (ld % tsp::vec_width<K>()) {     // rows not aligned for vector use
      err = static_cast<int>(cudaErrorInvalidValue);
    } else if (nsteps > 0) {
      err = launch<K, Val>(
          val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y, nsteps,
          s_batch, span_rows, group, gps, ld,
          static_cast<cudaStream_t>(stream));
    }
  });
  return ok ? err : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tsp_stream2(const float* val, const short* vidx,
                           const short* erow, const int* sbase,
                           const int* sbase2, const int* xmap, const int* cw,
                           const int* sactive, const float* x, float* y,
                           int nsteps, int s_batch, int span_rows, int group,
                           int k_rhs, int ld, void* stream) {
  return launch_k(val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y,
                  nsteps, s_batch, span_rows, group, k_rhs, ld, stream);
}

extern "C" int tsp_stream2_bf16(const __nv_bfloat16* val, const short* vidx,
                                const short* erow, const int* sbase,
                                const int* sbase2, const int* xmap,
                                const int* cw, const int* sactive,
                                const float* x, float* y, int nsteps,
                                int s_batch, int span_rows, int group,
                                int k_rhs, int ld, void* stream) {
  return launch_k(val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y,
                  nsteps, s_batch, span_rows, group, k_rhs, ld, stream);
}
