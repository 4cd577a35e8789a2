// Band (brick) class SpMM over k right-hand sides for sm_90a, f32 and bf16
// values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_band_spmm_kernel (called by
// band_spmm_call): for each RHS r < K,
//   Y[((cw*256 + t)*16 + i)*K + r] +=
//     sum_cb sum_j val[w, cb, j, i, t] * X[(tilecol(bloc[t] + cb)*16 + j)*K + r],
// tilecol(loc) = pb[w*kp + (loc >> 8)]*256 + (loc & 255), with X (rows, K)
// and Y (ylen, K) row-major: band.cu's indices, one RHS per column.
//
// Bound: device-memory bytes. The brick (C column blocks of 16 x 16
// values a lane, zeros included) is read once for all K columns: 2K flops
// per 4-byte value, 4 flop/B at K = 8, far under the FP32 units' 67 TFLOP/s
// over 3.35 TB/s (20 flop/B). So plain FP32 FMAs keep pace with the bytes
// and tensor cores would buy nothing, though a lane's column block is an
// MMA shape (16 x 16 by 16 x K); TF32's 10-bit mantissa would also miss the
// 1e-5 check against the plain version. Design: band.cu's block with K
// values a row:
// * a block is one group of 32 lanes of a window by all 16 rows; warp q
//   holds rows q*R .. q*R + R-1 of the 32 lanes (R = kRows: 4 up to K = 8,
//   2 above, the faster of 1, 2, 4 at K = 8 and at 16), so its loads of
//   val[w][cb][j][i][t0 .. t0+31] are coalesced; a thread keeps R x K sums
//   in registers;
// * a lane's X block for a column block is 16 rows of K floats, contiguous
//   in X (64K bytes, so 16-byte aligned for every K). The block's 32 blocks
//   are staged in shared memory by 16-byte cp.async copies, neighbouring
//   threads on neighbouring addresses, by lane (a window's panels need not
//   be adjacent in X); each staged row of K floats then feeds R x K FMAs;
// * one column block's staging is 32 x 16 x K floats (16 KB at K = 8, 32 KB
//   at K = 16): all C <= 8 at once would not fit a block at K = 16, so the
//   column blocks go through a ring of kStages slots (2: the next one is
//   copied while this one is multiplied);
// * every Y row has exactly one writer in the launch: the block's 32 lanes
//   x 16 rows are 512 contiguous rows of Y, added once through shared
//   memory (ring slot 0, after a barrier) by float4 read-modify-writes, with
//   no atomic (other classes add in other, stream-ordered launches);
// * every product is taken, zeros included (the brick is ~69% full), so a
//   non-finite X meets a zero value as 0*X, as in band_reference.
// The bf16 instance reads bf16 values (half the brick's bytes) into the
// same registers as floats; X, Y and the staging are f32 (values.cuh).
// scripts/spmm_probes.py times kRows 1, 2, 4, every column block staged at
// once (kStages 8) and each thread adding its rows into Y (kYShared 0).
#include <cuda_runtime.h>

#include "spmm_k.cuh"
#include "values.cuh"

namespace {

constexpr int kWindow = 256;  // ROW_WINDOW: lanes (tile-rows) per window
constexpr int kB = 16;        // tile edge
constexpr int kLanes = 32;    // lanes of a block: a warp's
// tile rows of a thread by K: 4 up to K = 8, 2 above (R x K sums and R x
// 16 values in registers)
template <int K>
constexpr int kRows = K <= 8 ? 4 : 2;
template <int K>
constexpr int kThreads = kLanes * kB / kRows<K>;
constexpr int kStages = 2;    // column blocks in the staging ring
constexpr int kYShared = 1;   // 0: each thread adds its own rows into Y
constexpr int kMaxC = 8;      // BAND_MAX_COLS
// dynamic shared memory a block may have: 227 KB less the static part
constexpr int kMaxSmem = 232448 - kMaxC * kLanes * 4;

// floats between two lanes' staged X blocks: 16 rows of K, padded by 4 so
// that each block starts on 16 bytes and neighbouring lanes' float4 reads
// fall in other banks
template <int K>
__host__ __device__ constexpr int xs_stride() {
  return kB * K + 4;
}

// bytes of one ring slot: a column block's 32 X blocks
template <int K>
__host__ __device__ constexpr int slot_bytes() {
  return kLanes * xs_stride<K>() * 4;
}

// the dynamic shared memory the kernel at K is set up for: the whole ring
// where it fits a block (kStages <= kMaxC)
template <int K>
__host__ __device__ constexpr int smem_cap() {
  return kStages * slot_bytes<K>() < kMaxSmem ? kStages * slot_bytes<K>()
                                              : kMaxSmem;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Val: the plan's value type (float or bf16); X, Y and the sums are f32
template <int K, typename Val>
__global__ void __launch_bounds__(kThreads<K>)
band_spmm_kernel(const Val* __restrict__ val, const int* __restrict__ bloc,
                 const int* __restrict__ pb, const int* __restrict__ cw,
                 const float* __restrict__ x, float* __restrict__ y,
                 int c_cols, int k_panels, int nslots) {
  constexpr int XS = xs_stride<K>();
  constexpr int kVec = kB * K / 4;     // float4 of a lane's X block
  constexpr int kGroups = kWindow / kLanes;
  constexpr int R = kRows<K>;
  constexpr int kT = kThreads<K>;
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // ring: [slot][lane][j][r]
  __shared__ int stc[kMaxC * kLanes];          // tile column of (cb, lane)
  const int w = blockIdx.x / kGroups;
  const int t0 = (blockIdx.x % kGroups) * kLanes;
  const int l = threadIdx.x % kLanes;
  const int i0 = threadIdx.x / kLanes * R;
  // val[w][cb][j][i][t]: (cb, j, r) at v[((cb*16 + j)*16 + r) * 256]
  const Val* v =
      val + ((long long)w * c_cols * kB * kB + i0) * kWindow + t0 + l;
  const int* bw = bloc + (long long)w * kWindow + t0;
  const int* pbw = pb + (long long)w * k_panels;
  // the block's 512 rows of Y, from row (cw*256 + t0)*16 on
  float* yb = y + ((long long)cw[w] * kWindow + t0) * kB * K;
  for (int e = threadIdx.x; e < c_cols * kLanes; e += kT) {
    const int loc = bw[e % kLanes] + e / kLanes;
    stc[e] = pbw[loc >> 8] * 256 + (loc & 255);
  }
  __syncthreads();
  // column block cb's 32 X blocks into ring slot cb % nslots: float4 f of
  // lane e / kVec by thread e (mod kT)
  auto stage = [&](int cb) {
    float* dst = xs + (cb % nslots) * kLanes * XS;
    const int* tc = stc + cb * kLanes;
    for (int e = threadIdx.x; e < kLanes * kVec; e += kT) {
      const int lane = e / kVec;
      const int f = e - lane * kVec;
      cp_async16(dst + lane * XS + 4 * f,
                 x + (long long)tc[lane] * kB * K + 4 * f);
    }
  };
  // one copy group a column block (empty past C), kStages - 1 ahead
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < c_cols) stage(s);
    cp_async_commit();
  }
  float acc[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < K; ++c) acc[r][c] = 0.f;
  }
  for (int cb = 0; cb < c_cols; ++cb) {
    // the column block's values first: they do not wait for X
    float a[R][kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r][j] = tsp::to_acc(v[((cb * kB + j) * kB + r) * kWindow]);
      }
    }
    // the slot it takes was last read before the barrier ending cb - 1
    if (cb + kStages - 1 < c_cols) stage(cb + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* xl = xs + (cb % nslots) * kLanes * XS + l * XS;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      float xr[K];
      tsp::load_row<K>(xl + j * K, xr);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          acc[r][c] = fmaf(a[r][j], xr[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kYShared != 0) {
    // lane-major as in Y, through ring slot 0, then float4 by float4
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tsp::store_row<K>(xs + l * XS + (i0 + r) * K, acc[r]);
    }
    __syncthreads();
    float4* y4 = reinterpret_cast<float4*>(yb);
    for (int q = threadIdx.x; q < kLanes * kVec; q += kT) {
      const int lane = q / kVec;
      const float4 s = *reinterpret_cast<const float4*>(
          xs + lane * XS + 4 * (q - lane * kVec));
      float4 o = y4[q];
      o.x += s.x;
      o.y += s.y;
      o.z += s.z;
      o.w += s.w;
      y4[q] = o;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tsp::add_row<K>(yb + ((long long)l * kB + i0 + r) * K, acc[r]);
    }
  }
}

template <typename Val>
int launch(const Val* val, const int* bloc, const int* pb, const int* cw,
           const float* x, float* y, int nchunks, int c_cols, int k_panels,
           int k_rhs, void* stream) {
  if (c_cols < 1 || c_cols > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = static_cast<int>(cudaSuccess);
  const bool ok = tsp::with_k(k_rhs, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    static const cudaError_t attr = cudaFuncSetAttribute(
        band_spmm_kernel<K, Val>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_cap<K>());
    const int nslots = c_cols < kStages ? c_cols : kStages;
    const int smem = nslots * slot_bytes<K>();
    if (attr != cudaSuccess) {
      err = static_cast<int>(attr);
    } else if (smem > smem_cap<K>()) {
      err = static_cast<int>(cudaErrorInvalidValue);
    } else if (nchunks > 0) {
      band_spmm_kernel<K, Val>
          <<<nchunks * (kWindow / kLanes), kThreads<K>, smem,
             static_cast<cudaStream_t>(stream)>>>(
          val, bloc, pb, cw, x, y, c_cols, k_panels, nslots);
      err = static_cast<int>(cudaGetLastError());
    }
  });
  return ok ? err : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tsp_band_spmm(const float* val, const int* bloc,
                             const int* pb, const int* cw, const float* x,
                             float* y, int nchunks, int c_cols, int k_panels,
                             int k_rhs, void* stream) {
  return launch(val, bloc, pb, cw, x, y, nchunks, c_cols, k_panels, k_rhs,
                stream);
}

extern "C" int tsp_band_spmm_bf16(const __nv_bfloat16* val, const int* bloc,
                                  const int* pb, const int* cw,
                                  const float* x, float* y, int nchunks,
                                  int c_cols, int k_panels, int k_rhs,
                                  void* stream) {
  return launch(val, bloc, pb, cw, x, y, nchunks, c_cols, k_panels, k_rhs,
                stream);
}
