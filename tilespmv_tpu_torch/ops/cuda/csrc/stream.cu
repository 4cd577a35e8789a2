// Entry-stream (COO-tile) class SpMV for sm_90a, f32 and f64.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_stream_kernel with its f32
// body _stream_step (called by stream_class_call, rounds scatter), and
// stream_class_call's df64 call (:1888-1936, _stream_step_df64 :1634) as
// native FP64 over the plan's f64 values. One
// step = s_batch (8, 128) slabs of one 1024-row output window w. Per
// slab si: entry (k, l) with vidx v reads x[row*128 + (v & 127)],
//   row = sb + k*(R/8) + ((v >> 7) & (R/8 - 1)), sb = sbase[si], or
//   sbase2[si] when bit 13 of v is set (dual-span slabs), or
//   row = xmap[si*64 + ((v >> 7) & 7)*8 + k] (free-placement slabs);
// csum = inclusive prefix of val*x along each sublane's 128 lanes (lane 0
// is a reserved zero); then per round t, target (q, j) of the window adds
//   csum[src, rend[src, j]] - csum[src, rstart[src, j]], src = rsrc[q, j],
// from the step's stacked int8 planes (round t: S*8 rend rows, S*8
// rstart rows, S*8 rsrc rows; slab s's sublane k at row s*8 + k).
//
// Bound: device-memory bytes (4 or 8 B value + 2 B index per entry slot
// plus 3 B of planes per (round, target)) and gather latency. The TPU ran the
// prefix on its matrix unit and the rounds as hardware lane/sublane
// gathers; here a block of 256 threads owns a step: each warp scans one
// sublane (4 lanes per thread, then a shuffle scan) into shared memory,
// each thread then owns 4 of the window's 1024 targets and walks the
// rounds, summing the step's slabs in registers. One atomicAdd per
// nonzero target per step: the window's other steps run in other blocks.
// Steps whose slabs are all padding (sactive = 0) return at once. The f64
// instance keeps the same walk with a double prefix (8 KB of shared csum
// per slab) and a double shuffle scan, where the TPU ran a compensated
// double-f32 scan.
#include <cuda_runtime.h>

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kTargetsPerThread = kSubs * kLanes / kThreads;

template <typename V>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const V* __restrict__ val,
              const short* __restrict__ vidx,
              const signed char* __restrict__ planes,
              const int* __restrict__ sbase, const int* __restrict__ sbase2,
              const int* __restrict__ xmap, const int* __restrict__ cw,
              const int* __restrict__ sactive,
              const V* __restrict__ x, V* __restrict__ y,
              int s_batch, int rounds, int span_rows) {
  const int step = blockIdx.x;
  if (sactive[step] == 0) return;
  __shared__ V csum[kSubs][kLanes];
  const int tid = threadIdx.x;
  const int k = tid >> 5;            // sublane this warp scans
  const int lane_id = tid & 31;
  const int l0 = lane_id * 4;        // first of this thread's 4 lanes
  const int rows_per_sub = span_rows / 8;
  const long long sb8 = (long long)s_batch * kSubs;
  const signed char* ps =
      planes + (long long)step * rounds * 3 * sb8 * kLanes;
  V acc[kTargetsPerThread];
#pragma unroll
  for (int q = 0; q < kTargetsPerThread; ++q) acc[q] = 0;

  for (int s = 0; s < s_batch; ++s) {
    const long long si = (long long)step * s_batch + s;
    const long long e0 = (si * kSubs + k) * kLanes + l0;
    V c[4];
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
      c[u] = val[e0 + u] * x[row * kLanes + (v & 127u)];
    }
    c[1] += c[0];
    c[2] += c[1];
    c[3] += c[2];
    V inc = c[3];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const V n = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane_id >= off) inc += n;
    }
    const V excl = inc - c[3];
#pragma unroll
    for (int u = 0; u < 4; ++u) csum[k][l0 + u] = c[u] + excl;
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
        acc[q] += csum[src][e] - csum[src][st];
      }
    }
    __syncthreads();
  }
  V* yw = y + (long long)cw[step] * kSubs * kLanes;
#pragma unroll
  for (int q = 0; q < kTargetsPerThread; ++q) {
    if (acc[q] != 0) atomicAdd(yw + tid + q * kThreads, acc[q]);
  }
}

template <typename V>
int launch(const V* val, const short* vidx, const signed char* planes,
           const int* sbase, const int* sbase2, const int* xmap,
           const int* cw, const int* sactive, const V* x, V* y, int nsteps,
           int s_batch, int rounds, int span_rows, void* stream) {
  if (nsteps > 0) {
    stream_kernel<V><<<nsteps, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        val, vidx, planes, sbase, sbase2, xmap, cw, sactive, x, y, s_batch,
        rounds, span_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_stream(const float* val, const short* vidx,
                          const signed char* planes, const int* sbase,
                          const int* sbase2, const int* xmap, const int* cw,
                          const int* sactive, const float* x, float* y,
                          int nsteps, int s_batch, int rounds,
                          int span_rows, void* stream) {
  return launch(val, vidx, planes, sbase, sbase2, xmap, cw, sactive, x, y,
                nsteps, s_batch, rounds, span_rows, stream);
}

extern "C" int tsp_stream_f64(const double* val, const short* vidx,
                              const signed char* planes, const int* sbase,
                              const int* sbase2, const int* xmap,
                              const int* cw, const int* sactive,
                              const double* x, double* y, int nsteps,
                              int s_batch, int rounds, int span_rows,
                              void* stream) {
  return launch(val, vidx, planes, sbase, sbase2, xmap, cw, sactive, x, y,
                nsteps, s_batch, rounds, span_rows, stream);
}
