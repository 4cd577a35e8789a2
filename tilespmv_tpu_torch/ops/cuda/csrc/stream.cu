// Entry-stream (COO-tile) class SpMV for sm_90a, f32, f64 and bf16
// values.
//
// Replaces tilespmv_tpu/ops/pallas/kernels.py:_stream_kernel with its f32
// body _stream_step (called by stream_class_call, rounds scatter), and
// stream_class_call's df64 call (:1888-1936, _stream_step_df64 :1634) as
// native FP64 over the plan's f64 values. It computes what they compute,
// but not the way they do: the TPU could route partial sums only with
// lane and sublane gathers, so its plan carries int8 round planes
// (rend/rstart/rsrc per round and target) and its kernel takes a prefix
// along each sublane and boundary differences per round. Here every
// entry slot carries its own output row instead (StreamChunks.erow, the
// same routing read off the planes at plan time), and the planes are not
// read at all.
//
// Per slab si: entry (k, l) with vidx v and erow r >= 0 adds
//   val * x[row*128 + (v & 127)] into y[cw[step]*1024 + r],
//   row = sb + k*(R/8) + ((v >> 7) & (R/8 - 1)), sb = sbase[si], or
//   sbase2[si] when bit 13 of v is set (dual-span slabs), or
//   row = xmap[si*64 + ((v >> 7) & 7)*8 + k] (free-placement slabs);
// r = -1 marks lane 0 and padding.
//
// Bound: device-memory bytes, 8 B per f32 slot (4 B value, 2 B vidx, 2 B
// erow), 12 B per f64 slot and 6 B per bf16 slot, read once; x (a few MB)
// is gathered from L2. Design: a block of 256 threads takes `group`
// consecutive slabs of one step (grid nsteps * ceil(S / group), so the
// parallelism does not follow the planner's S); warp k reads sublane k of
// each slab, 4 consecutive lanes per thread as one 16-B value load (two
// for f64, one 8-B load for bf16) and 8-B vidx and erow loads. erow is
// non-decreasing along a sublane's entries, so a segmented inclusive scan
// keyed on it (in registers, then across the warp by shuffles) sums each
// run of one row, and the run's last lane adds it into the block's
// 1024-entry window in shared memory. After the group, one atomicAdd per
// nonzero window entry into y: the window's other groups and steps run in
// other blocks. Steps whose slabs are all padding (sactive = 0) return at
// once; a sublane with no entry skips its value loads and gathers. bf16
// values are widened to f32 as they are loaded; x, y and the sums are f32
// (values.cuh).
#include <cuda_runtime.h>

#include "values.cuh"

namespace {

constexpr int kSubs = 8;
constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWindow = kSubs * kLanes;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// four bf16 as floats from one 8-B load
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = tsp::bf16x2_to_float2(a.x);
  const float2 hi = tsp::bf16x2_to_float2(a.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// four int16 as ints (sign-extended) from one 8-B load
__device__ __forceinline__ void load4(const short* p, int (&v)[4]) {
  const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = static_cast<short>(a.x & 0xffffu);
  v[1] = static_cast<short>(a.x >> 16);
  v[2] = static_cast<short>(a.y & 0xffffu);
  v[3] = static_cast<short>(a.y >> 16);
}

// Val: the plan's value type; V: the compute type of x, y and the sums
template <typename Val, typename V = tsp::acc_t<Val>>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const Val* __restrict__ val, const short* __restrict__ vidx,
              const short* __restrict__ erow,
              const int* __restrict__ sbase, const int* __restrict__ sbase2,
              const int* __restrict__ xmap, const int* __restrict__ cw,
              const int* __restrict__ sactive,
              const V* __restrict__ x, V* __restrict__ y,
              int s_batch, int group, int groups_per_step, int span_rows) {
  const int step = blockIdx.x / groups_per_step;
  if (sactive[step] == 0) return;
  const int g0 = (blockIdx.x - step * groups_per_step) * group;
  const int g1 = min(g0 + group, s_batch);
  __shared__ V win[kWindow];
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = tid; i < kWindow; i += kThreads) win[i] = 0;
  __syncthreads();

  const int k = tid >> 5;            // sublane this warp reads
  const int lane_id = tid & 31;
  const int l0 = lane_id * 4;        // first of this thread's 4 lanes
  const int rows_per_sub = span_rows / 8;
  for (int s = g0; s < g1; ++s) {
    const long long si = (long long)step * s_batch + s;
    const long long e0 = (si * kSubs + k) * kLanes + l0;
    int r[4];
    load4(erow + e0, r);
    if (!__any_sync(kFull, max(max(r[0], r[1]), max(r[2], r[3])) >= 0)) {
      continue;                      // no entry in this sublane
    }
    V v[4];
    int ci[4];
    load4(val + e0, v);
    load4(vidx + e0, ci);
    int sb = 0, sb2 = 0;
    if (xmap == nullptr) {
      sb = sbase[si];
      sb2 = sbase2[si];
    }
    V c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = 0;
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
        c[u] = v[u] * x[row * kLanes + (cv & 127u)];
      }
    }
    // segmented inclusive sums within the thread's 4 lanes
    if (r[1] == r[0]) c[1] += c[0];
    if (r[2] == r[1]) c[2] += c[1];
    if (r[3] == r[2]) c[3] += c[2];
    const int prev_r3 = __shfl_up_sync(kFull, r[3], 1);
    const int next_r0 = __shfl_down_sync(kFull, r[0], 1);
    const bool whole = r[0] == r[1] && r[1] == r[2] && r[2] == r[3];
    // (head, tot): does the thread's last run start in it, and that
    // run's sum so far; scanned across the warp
    int head = !(whole && lane_id > 0 && prev_r3 == r[3]);
    V tot = c[3];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const V nt = __shfl_up_sync(kFull, tot, off);
      const int nh = __shfl_up_sync(kFull, head, off);
      if (lane_id >= off) {
        if (!head) tot += nt;
        head |= nh;
      }
    }
    // the run the previous thread ended in, if it goes on here
    const V cin = __shfl_up_sync(kFull, tot, 1);
    const bool carry = lane_id > 0 && prev_r3 == r[0];
    bool lead = true;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lead = lead && r[u] == r[0];
      if (carry && lead) c[u] += cin;
      const bool end = u < 3 ? r[u] != r[u + 1]
                             : (lane_id == 31 || next_r0 != r[3]);
      if (end && r[u] >= 0) atomicAdd(&win[r[u]], c[u]);
    }
  }
  __syncthreads();
  V* yw = y + (long long)cw[step] * kWindow;
#pragma unroll
  for (int i = tid; i < kWindow; i += kThreads) {
    const V a = win[i];
    if (a != 0) atomicAdd(yw + i, a);
  }
}

template <typename Val, typename V>
int launch(const Val* val, const short* vidx, const short* erow,
           const int* sbase, const int* sbase2, const int* xmap,
           const int* cw, const int* sactive, const V* x, V* y, int nsteps,
           int s_batch, int span_rows, int group, void* stream) {
  const int gps = group > 0 ? (s_batch + group - 1) / group : 0;
  if (gps < 1 || (long long)nsteps * gps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nsteps > 0) {
    stream_kernel<Val><<<nsteps * gps, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y, s_batch,
        group, gps, span_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsp_stream(const float* val, const short* vidx,
                          const short* erow, const int* sbase,
                          const int* sbase2, const int* xmap, const int* cw,
                          const int* sactive, const float* x, float* y,
                          int nsteps, int s_batch, int span_rows, int group,
                          void* stream) {
  return launch(val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y,
                nsteps, s_batch, span_rows, group, stream);
}

extern "C" int tsp_stream_f64(const double* val, const short* vidx,
                              const short* erow, const int* sbase,
                              const int* sbase2, const int* xmap,
                              const int* cw, const int* sactive,
                              const double* x, double* y, int nsteps,
                              int s_batch, int span_rows, int group,
                              void* stream) {
  return launch(val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y,
                nsteps, s_batch, span_rows, group, stream);
}

extern "C" int tsp_stream_bf16(const __nv_bfloat16* val, const short* vidx,
                               const short* erow, const int* sbase,
                               const int* sbase2, const int* xmap,
                               const int* cw, const int* sactive,
                               const float* x, float* y, int nsteps,
                               int s_batch, int span_rows, int group,
                               void* stream) {
  return launch(val, vidx, erow, sbase, sbase2, xmap, cw, sactive, x, y,
                nsteps, s_batch, span_rows, group, stream);
}
