// Entry-stream (COO-tile) class over two right-hand sides for sm_90a.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_stream_kernel2 (called by
// stream_class_call2): the stream step of stream.cu for RHS r0 and r0+1
// of X (rows, ld) into Y (ylen, ld), both row-major. Per slab si, entry
// (k, l) with vidx v reads X[(row*128 + (v & 127))*ld + r0 + {0, 1}], with
// stream.cu's row (sbase / sbase2 on bit 13 of v for dual-span slabs,
// xmap for free-placement slabs: the TPU kernel permuted x for those,
// stream_class_call2's `permute`); each RHS gets its inclusive lane
// prefix csum; per round t, target (q, j) of window w adds
//   csum[src, rend[src, j]] - csum[src, rstart[src, j]], src = rsrc[q, j]
// into Y[(w*1024 + q*128 + j)*ld + r0 + {0, 1}].
//
// Bound: device-memory bytes of the plan (4 B value + 2 B index per slot,
// 3 B of planes per (round, target)) and gather latency, as stream.cu.
// The fused kernel reads the slab's vidx/val and the step's int8 round
// planes once for both RHS, which is what it saves over two SpMVs. Design:
// stream.cu's, with two shared csum[8][128] arrays (8 KB), two warp
// shuffle scans per sublane, and two accumulators per target; one
// atomicAdd per nonzero (target, RHS) per step, since a window's other
// steps run in other blocks. Steps with sactive = 0 return at once.
#include <cuda_runtime.h>

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kTargetsPerThread = kSubs * kLanes / kThreads;

// inclusive prefix of c[0..3] across the warp's 128 lanes (4 per thread)
__device__ __forceinline__ void lane_prefix(float c[4], int lane_id) {
  c[1] += c[0];
  c[2] += c[1];
  c[3] += c[2];
  float inc = c[3];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane_id >= off) inc += n;
  }
  const float excl = inc - c[3];
#pragma unroll
  for (int u = 0; u < 4; ++u) c[u] += excl;
}

__global__ void __launch_bounds__(kThreads)
stream2_kernel(const float* __restrict__ val,
               const short* __restrict__ vidx,
               const signed char* __restrict__ planes,
               const int* __restrict__ sbase, const int* __restrict__ sbase2,
               const int* __restrict__ xmap, const int* __restrict__ cw,
               const int* __restrict__ sactive,
               const float* __restrict__ x, float* __restrict__ y,
               int s_batch, int rounds, int span_rows, int ld, int r0) {
  const int step = blockIdx.x;
  if (sactive[step] == 0) return;
  __shared__ float csum[2][kSubs][kLanes];
  const int tid = threadIdx.x;
  const int k = tid >> 5;            // sublane this warp scans
  const int lane_id = tid & 31;
  const int l0 = lane_id * 4;        // first of this thread's 4 lanes
  const int rows_per_sub = span_rows / 8;
  const long long sb8 = (long long)s_batch * kSubs;
  const signed char* ps =
      planes + (long long)step * rounds * 3 * sb8 * kLanes;
  const float* xr0 = x + r0;
  float acc[2][kTargetsPerThread];
#pragma unroll
  for (int q = 0; q < kTargetsPerThread; ++q) acc[0][q] = acc[1][q] = 0.f;

  for (int s = 0; s < s_batch; ++s) {
    const long long si = (long long)step * s_batch + s;
    const long long e0 = (si * kSubs + k) * kLanes + l0;
    float ca[4], cb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned v = static_cast<unsigned short>(vidx[e0 + u]);
      const int ch = static_cast<int>((v >> 7) & (rows_per_sub - 1));
      long long row;
      if (xmap != nullptr) {
        row = xmap[si * 64 + ch * kSubs + k];
      } else {
        const int sb = ((v >> 13) & 1u) ? sbase2[si] : sbase[si];
        row = (long long)sb + k * rows_per_sub + ch;
      }
      const float a = val[e0 + u];
      const float* xe = xr0 + (row * kLanes + (v & 127u)) * ld;
      ca[u] = a * xe[0];
      cb[u] = a * xe[1];
    }
    lane_prefix(ca, lane_id);
    lane_prefix(cb, lane_id);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      csum[0][k][l0 + u] = ca[u];
      csum[1][k][l0 + u] = cb[u];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kTargetsPerThread; ++q) {
      const int idx = tid + q * kThreads;
      const int tq = idx >> 7;
      const int j = idx & (kLanes - 1);
      for (int t = 0; t < rounds; ++t) {
        const signed char* pt = ps + (long long)t * 3 * sb8 * kLanes;
        const int src = pt[(2 * sb8 + s * kSubs + tq) * kLanes + j];
        const int e = pt[(s * kSubs + src) * kLanes + j];
        const int st = pt[(sb8 + s * kSubs + src) * kLanes + j];
        acc[0][q] += csum[0][src][e] - csum[0][src][st];
        acc[1][q] += csum[1][src][e] - csum[1][src][st];
      }
    }
    __syncthreads();
  }
  float* yw = y + (long long)cw[step] * kSubs * kLanes * ld + r0;
#pragma unroll
  for (int q = 0; q < kTargetsPerThread; ++q) {
    float* yq = yw + (long long)(tid + q * kThreads) * ld;
    if (acc[0][q] != 0.f) atomicAdd(yq, acc[0][q]);
    if (acc[1][q] != 0.f) atomicAdd(yq + 1, acc[1][q]);
  }
}

}  // namespace

extern "C" int tsp_stream2(const float* val, const short* vidx,
                           const signed char* planes, const int* sbase,
                           const int* sbase2, const int* xmap, const int* cw,
                           const int* sactive, const float* x, float* y,
                           int nsteps, int s_batch, int rounds, int span_rows,
                           int ld, int r0, void* stream) {
  if (nsteps > 0) {
    stream2_kernel<<<nsteps, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        val, vidx, planes, sbase, sbase2, xmap, cw, sactive, x, y, s_batch,
        rounds, span_rows, ld, r0);
  }
  return static_cast<int>(cudaGetLastError());
}
