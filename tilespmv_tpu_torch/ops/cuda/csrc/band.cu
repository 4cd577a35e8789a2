// Band (brick) class SpMV for sm_90a, f32, f64 and bf16 values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_band_kernel (called by
// band_class_call; f32 arm, and the df64 arms :545-621 as native FP64):
// y[(cw*256 + t)*16 + i] +=
//   sum_cb sum_j val[w, cb, j, i, t] * x[(tilecol(bloc[t] + cb))*16 + j],
// tilecol(loc) = pb[w*K + (loc >> 8)]*256 + (loc & 255).
//
// Bound: device-memory bytes. The (nchunks, C, 16, 16, 256) brick
// payload is read once at one FMA per value (4, 8 or 2 bytes), far below the
// FP32 and FP64 rates; x (a few MB) stays in L2. A lane's x block lies
// 16 values from its neighbour's, so reading it per lane costs a 32-byte
// sector for every lane of a warp, several times the value loads' L1
// traffic. Design:
// * a block is one group of 32 lanes (tile-rows) of a window by all 16
//   rows; warp q holds rows q*R .. q*R + R-1 of the 32 lanes (R = kRows:
//   1 in f64, 2 in f32, the faster of 1, 2, 4 in each), so its loads of
//   val[w][cb][j][i][t0 .. t0+31] are coalesced;
// * the group's x blocks, C of 16 values per lane, are staged once in
//   shared memory, 16 neighbouring threads reading one tile's 16
//   contiguous values, and each staged value feeds R FMAs; staged by
//   lane, since a window's K panels (pb) need not be adjacent in x;
// * every y row has exactly one writer in the launch: the block adds its
//   32 lanes x 16 rows, 512 contiguous rows of y, through shared memory,
//   with no atomic (other classes add in other, stream-ordered launches);
// * every product is taken, zeros included (the brick is ~69% full), so
//   a non-finite x meets a zero value as 0*x, as in band_reference.
// The TPU emulated f64 with f32 pairs; the f64 instance reads the plan's
// f64 values and accumulates in native FP64. The bf16 instance reads bf16
// values (half the brick's bytes) into the f32 kernel's registers, x, y
// and the staging being f32 as in the reference (values.cuh).
// scripts/band_probes.py times kRows in {1, 2, 4} and copies with x read
// per lane or not at all.
#include <cuda_runtime.h>

#include "values.cuh"

namespace {

constexpr int kWindow = 256;  // ROW_WINDOW: lanes (tile-rows) per window
constexpr int kB = 16;        // tile edge
constexpr int kPad = kB + 1;  // staged row stride: no bank conflicts
constexpr int kLanes = 32;    // lanes of a block: a warp's
// tile rows of a thread by compute type: 1 in f64, 2 in f32 (f32 and bf16
// values)
template <typename V>
constexpr int kRows = sizeof(V) == 8 ? 1 : 2;
template <typename V>
constexpr int kWarps = kB / kRows<V>;
constexpr int kMaxC = 8;      // BAND_MAX_COLS: C*32*17 values staged

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// Val: the plan's value type; V: the compute type of x, y and the sums
template <typename Val, typename V = tsp::acc_t<Val>>
__global__ void __launch_bounds__(kLanes * kWarps<V>)
band_kernel(const Val* __restrict__ val, const int* __restrict__ bloc,
            const int* __restrict__ pb, const int* __restrict__ cw,
            const V* __restrict__ x, V* __restrict__ y, int c_cols,
            int k_panels) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* xs = reinterpret_cast<V*>(smem);   // [cb][lane][j], rows of kPad
  constexpr int kGroups = kWindow / kLanes;
  const int w = blockIdx.x / kGroups;
  const int t0 = (blockIdx.x % kGroups) * kLanes;
  const int l = threadIdx.x % kLanes;
  const int i0 = threadIdx.x / kLanes * kRows<V>;
  // val[w][cb][j][i][t]: (cb, j, r) at v[((cb*16 + j)*16 + r) * 256]
  const Val* v =
      val + ((long long)w * c_cols * kB * kB + i0) * kWindow + t0 + l;
  // the first column block's values: they do not wait for x
  constexpr int R = kRows<V>;
  V a[R][kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r][j] = tsp::to_acc(v[(j * kB + r) * kWindow]);
    }
  }
  // the 32 lanes' x blocks, entry (cb, lane, column) by thread
  const int* bw = bloc + (long long)w * kWindow + t0;
  const int* pbw = pb + (long long)w * k_panels;
  const int nstage = c_cols * kLanes * kB;
  for (int e = threadIdx.x; e < nstage; e += kLanes * kWarps<V>) {
    const int loc = bw[e / kB % kLanes] + e / (kLanes * kB);
    xs[e / kB * kPad + e % kB] =
        x[((long long)pbw[loc >> 8] * 256 + (loc & 255)) * kB + e % kB];
  }
  __syncthreads();
  V acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
  for (int cb = 0; cb < c_cols; ++cb) {
    if (cb > 0) {
#pragma unroll
      for (int j = 0; j < kB; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r][j] = tsp::to_acc(v[((cb * kB + j) * kB + r) * kWindow]);
        }
      }
    }
    const V* xl = xs + (cb * kLanes + l) * kPad;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const V xj = xl[j];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmadd(a[r][j], xj, acc[r]);
    }
  }
  // the block's 512 rows of y, lane-major as in y, through xs
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) xs[l * kPad + i0 + r] = acc[r];
  __syncthreads();
  V* yb = y + ((long long)cw[w] * kWindow + t0) * kB;
  for (int q = threadIdx.x; q < kLanes * kB; q += kLanes * kWarps<V>) {
    yb[q] += xs[q / kB * kPad + q % kB];
  }
}

template <typename Val, typename V>
int launch(const Val* val, const int* bloc, const int* pb, const int* cw,
           const V* x, V* y, int nchunks, int c_cols, int k_panels,
           void* stream) {
  if (c_cols < 1 || c_cols > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    const size_t smem = sizeof(V) * c_cols * kLanes * kPad;
    band_kernel<Val><<<nchunks * (kWindow / kLanes), kLanes * kWarps<V>, smem,
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

extern "C" int tsp_band_bf16(const __nv_bfloat16* val, const int* bloc,
                             const int* pb, const int* cw, const float* x,
                             float* y, int nchunks, int c_cols, int k_panels,
                             void* stream) {
  return launch(val, bloc, pb, cw, x, y, nchunks, c_cols, k_panels, stream);
}
