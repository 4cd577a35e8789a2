// Value types of the class kernels.
//
// A kernel reads its plan's values as Val and computes in acc_t<Val>:
// float for float and bf16 values, double for double. A bf16 plan's x
// and y are float buffers (the reference casts bf16 values and x to f32
// before it multiplies, and accumulates in f32,
// tilespmv_tpu/ops/pallas/kernels.py:357, :430, :537, :1937), so only the
// value loads differ from the f32 kernel: each value is widened as it is
// loaded. The widening is exact (a bf16 is the high half of an f32), and
// so is the product of a bf16 value and a bf16-exact x in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tsp {

template <typename Val>
struct acc_type {
  using type = Val;
};
template <>
struct acc_type<__nv_bfloat16> {
  using type = float;
};
template <typename Val>
using acc_t = typename acc_type<Val>::type;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the two bf16 of one 32-bit word as floats (element 0 in the low half)
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

}  // namespace tsp
