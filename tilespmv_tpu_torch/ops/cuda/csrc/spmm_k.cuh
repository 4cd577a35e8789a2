// Shared pieces of the fused SpMM kernels: dispatch of a runtime
// right-hand-side count k onto a compile-time K, and row access.
//
// The kernels keep K accumulators per thread in registers; an array
// indexed by a runtime k would live in local memory instead. So each
// kernel is a template on K, instantiated for the range the reference
// package fuses (tilespmv_tpu/ops/spmv.py:84, 2 <= k <= 16). X and Y are
// row-major (rows, K): a thread reads and writes whole rows of K floats,
// with the widest loads the row's alignment allows (the wrappers pass
// 16-byte-aligned X and Y, so a row starts on a 16-byte boundary when
// K % 4 == 0 and on an 8-byte one when K % 2 == 0).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tsp {

constexpr int kSpmmMinK = 2;
constexpr int kSpmmMaxK = 16;

// Calls f(std::integral_constant<int, K>{}) with K == k; returns false
// (and calls nothing) when k is outside [kSpmmMinK, kSpmmMaxK].
template <int K = kSpmmMinK, typename F>
bool with_k(int k, F&& f) {
  if constexpr (K > kSpmmMaxK) {
    return false;
  } else {
    if (k == K) {
      f(std::integral_constant<int, K>{});
      return true;
    }
    return with_k<K + 1>(k, f);
  }
}

// floats of the widest load a row of K floats allows: 4, 2 or 1
template <int K>
__host__ __device__ constexpr int vec_width() {
  return K % 4 == 0 ? 4 : K % 2 == 0 ? 2 : 1;
}

// acc[r] = fmaf(a, xr[r], acc[r]) for r < K
template <int K>
__device__ __forceinline__ void fma_row(float a,
                                        const float* __restrict__ xr,
                                        float (&acc)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + r);
      acc[r] = fmaf(a, v.x, acc[r]);
      acc[r + 1] = fmaf(a, v.y, acc[r + 1]);
      acc[r + 2] = fmaf(a, v.z, acc[r + 2]);
      acc[r + 3] = fmaf(a, v.w, acc[r + 3]);
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 2) {
      const float2 v = *reinterpret_cast<const float2*>(xr + r);
      acc[r] = fmaf(a, v.x, acc[r]);
      acc[r + 1] = fmaf(a, v.y, acc[r + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = fmaf(a, xr[r], acc[r]);
  }
}

// v[r] = xr[r] for r < K, by the widest loads the row allows (shared or
// global memory)
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ xr,
                                         float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xr + r);
      v[r] = a.x;
      v[r + 1] = a.y;
      v[r + 2] = a.z;
      v[r + 3] = a.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 2) {
      const float2 a = *reinterpret_cast<const float2*>(xr + r);
      v[r] = a.x;
      v[r + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = xr[r];
  }
}

// yr[r] = v[r] for r < K, by the widest stores the row allows
template <int K>
__device__ __forceinline__ void store_row(float* __restrict__ yr,
                                          const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 4) {
      *reinterpret_cast<float4*>(yr + r) =
          make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 2) {
      *reinterpret_cast<float2*>(yr + r) = make_float2(v[r], v[r + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) yr[r] = v[r];
  }
}

// atomicAdd(yr + r, acc[r]) for r < K, V columns an atomicAdd: V = 4 or
// 2 are sm_90's float4 / float2 atomicAdd in global memory (yr aligned
// to V floats), V = 1 scalar ones (shared or global memory)
template <int K, int V = 1>
__device__ __forceinline__ void atomic_add_row(float* yr,
                                               const float (&acc)[K]) {
#pragma unroll
  for (int r = 0; r < K; r += V) {
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(yr + r),
                make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]));
    } else if constexpr (V == 2) {
      atomicAdd(reinterpret_cast<float2*>(yr + r),
                make_float2(acc[r], acc[r + 1]));
    } else {
      atomicAdd(yr + r, acc[r]);
    }
  }
}

// atomicAdd of w[0..V) into y[0..V) as one V-float vector where any of
// them is nonzero: V = 4 or 2 are sm_90's float4 / float2 atomicAdd in
// global memory (y aligned to V floats), V = 1 a scalar one
template <int V>
__device__ __forceinline__ void atomic_add_nonzero(float* y, const float* w) {
  if constexpr (V == 4) {
    const float4 a = make_float4(w[0], w[1], w[2], w[3]);
    if (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f) {
      atomicAdd(reinterpret_cast<float4*>(y), a);
    }
  } else if constexpr (V == 2) {
    const float2 a = make_float2(w[0], w[1]);
    if (a.x != 0.f || a.y != 0.f) atomicAdd(reinterpret_cast<float2*>(y), a);
  } else {
    if (w[0] != 0.f) atomicAdd(y, w[0]);
  }
}

// yr[r] += acc[r] for r < K (the caller is the row's only writer)
template <int K>
__device__ __forceinline__ void add_row(float* __restrict__ yr,
                                        const float (&acc)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int r = 0; r < K; r += 4) {
      float4* p = reinterpret_cast<float4*>(yr + r);
      float4 v = *p;
      v.x += acc[r];
      v.y += acc[r + 1];
      v.z += acc[r + 2];
      v.w += acc[r + 3];
      *p = v;
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) yr[r] += acc[r];
  }
}

}  // namespace tsp
