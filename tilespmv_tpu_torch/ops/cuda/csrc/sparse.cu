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
// so chunk c's rows start at meta + c*meta_rows*T. T is 128 (SPARSE_T).
//
// Bound: device-memory bytes, each chunk's values and its first
// 2 + W/8 + 4 meta rows read once: about 5.1 bytes a value slot in f32
// at W = 32 (3.1 in bf16). x and y (32 MB each on HPCG's 200^3 grid) are
// what the L2 keeps for the gathers and the atomics. A chunk's values
// (W x 128 slots) and those meta rows are each one contiguous run of
// 4.5-48 KB.
//
// The kernel's earlier grid, one block a 32-lane group, read its 4-9 KB
// at its start and then ran a serial tail with no load in flight (the x
// block behind xloc, shared float atomics, three barriers, global
// atomics). On HPCG's
// stencil at 200^3 it streamed the W-classes' 1,537 MB in 1.682 ms
// (0.91 TB/s); scripts/sparse_probes.py read launch and blocks alone
// 0.153 ms, no x blocks 1.150, no flush 1.446 (f32, H100 SXM at 700 W).
// The stream, not the atomics, set the pace. Design:
// * persistent: min(chunks, blocks an SM x SMs) blocks, each walking
//   chunks blockIdx.x, blockIdx.x + gridDim.x, ... (a class of fewer
//   chunks gets one block a chunk);
// * a ring of `stages` shared-memory stages: up to kMaxStages, in up to
//   kMaxBlocks blocks an SM that hold two stages each (else one block).
//   One producer lane copies a chunk's values and meta rows into a stage
//   by two bulk asynchronous copies (cp.async.bulk, completing on the
//   stage's mbarrier, L2 evict-first so that the stream leaves x and y
//   in the L2) as soon as every consumer warp has released it;
// * the consumers: four lane groups of 32 lanes, each of kRowGroups
//   warps, warp g summing rows g*kRows .. of its 32 tiles from the stage
//   (row by row, each row its own slots in slot order, into registers:
//   no shared atomics). A lane group waits only for its own warps (two
//   named barriers a chunk), so the groups drift apart by up to the
//   ring's depth. A lane's x block is staged column-major in shared
//   memory (each lane reads its own bank) by its kRowGroups threads, a
//   float4 each; the next chunk's x loads are issued as soon as a warp
//   has released its stage and are in flight through the flush;
// * the flush: the lanes' sums go through shared memory; the first lane
//   of a warp's lanes on one tile row (__match_any_sync: a dense matrix
//   row puts one tile row on every lane) adds theirs, its own first and
//   the others in lane order, and one thread a (lane, 4 rows), four
//   neighbouring threads on a tile row's 16, adds them into y by a float4
//   atomic where any of the 4 rows holds entries.
// There (the same probes, the three W-classes as one call): 0.798 ms,
// 1.93 TB/s; without the rows' sums 0.611, without the flush 0.685,
// without the x blocks 0.736; 1 stage 0.928; 8 or 16 rows a thread
// 0.899 / 1.446; one atomic a (tile, 4 rows) 0.775, but 1.48x the kept
// arm on mixed_large, whose dense row puts 4,093 tiles on one tile row.
// Each row sums its own slots: a non-finite x reaches only the rows whose
// entries read it, as in the CSR product (the TPU's differences of a
// prefix over every slot put NaN in other rows of the tile; ROADMAP.md C).
// The bf16 instance reads bf16 values and computes as the f32 one, on f32
// x and y (values.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "values.cuh"

namespace {

constexpr int kB = 16;          // rows and columns of a tile
constexpr int kT = 128;         // lanes (tiles) of a chunk: SPARSE_T
constexpr int kRowGroups = 4;   // threads a lane, each summing kRows rows
constexpr int kRows = kB / kRowGroups;
constexpr int kCols = kB / kRowGroups;  // x block columns a thread stages
constexpr int kMaxStages = 4;   // ring stages, at most
constexpr int kMaxBlocks = 2;   // blocks an SM, at most
constexpr int kMaxW = 96;       // the widest class (W_CHOICES)
constexpr int kMaxK = 8;        // the most x panels of a step (K_CHOICES)
constexpr int kConsumers = kT * kRowGroups;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
// shared memory before the ring: the 2 * kMaxStages mbarriers, the x
// blocks (xs, column-major), the lanes' row sums (ys, a lane's 16 rows
// together), each (row group, lane)'s rows with entries (hs), each
// lane's warp lanes on its tile row (grp, 0 for an inert lane) and its
// tile row (rows)
constexpr int kBarBytes = 128;
constexpr int kXsOff = kBarBytes;
constexpr int kYsOff = kXsOff + kB * kT * 4;
constexpr int kHsOff = kYsOff + kT * kB * 4;
constexpr int kGrpOff = kHsOff + kRowGroups * kT * 4;
constexpr int kRowsOff = kGrpOff + kT * 4;
constexpr int kFixedBytes = kRowsOff + kT * 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` of *b has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` into shared `dst` (both
// 16-byte aligned), completing on *bar, with the L2 policy `policy`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// rend[r] of lane t's tile, from the stage's meta rows (`rw` the first
// row-end row)
__device__ __forceinline__ int rend_at(const int* rw, int r) {
  return static_cast<int>(static_cast<unsigned>(rw[(r >> 2) * kT]) >>
                          ((r & 3) * 8) & 255u);
}

// the barrier of lane group `lg`: its kRowGroups warps (named barrier
// 1 + lg; the producer warp is in none)
__device__ __forceinline__ void group_sync(int lg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + lg), "n"(32 * kRowGroups)
               : "memory");
}

// A unit (chunk) as a consumer thread sees it: its step's window and,
// once its stage has arrived, the lane's xloc and tile row, and the
// thread's columns of the lane's x block
struct Unit {
  int c = 0, win = 0, xloc = -1, lrow = 0;
  float xv[kCols];
};

// unit u (the j-th of the block): its step's window and panel ids (lane
// k of the warp loads the k-th), then, once its stage has arrived, lane
// t's xloc and tile row and the loads of the thread's columns of its x
// block, issued only (the warp's threads all take part: the panel id is
// shuffled)
__device__ __forceinline__ void unit_head(Unit& u, int j, int stages,
                                          const unsigned char* ring,
                                          unsigned sbytes, unsigned vbytes,
                                          uint64_t* full, const int* pb,
                                          const int* cw, const float* x,
                                          int k_panels, int c_batch, int t,
                                          int g, int lane) {
  const int step = u.c / c_batch;
  u.win = cw[step];
  const int pbl =
      lane < k_panels ? pb[(long long)step * k_panels + lane] : 0;
  const int st = j % stages;
  mbar_wait(full + st, (j / stages) & 1);
  const int* ms =
      reinterpret_cast<const int*>(ring + st * sbytes + vbytes) + t;
  u.xloc = ms[0];
  u.lrow = ms[kT];
  const int panel =
      __shfl_sync(0xffffffffu, pbl, u.xloc >= 0 ? u.xloc >> 8 : 0);
  if (u.xloc >= 0) {
    const float* xg =
        x + ((long long)panel * 256 + (u.xloc & 255)) * kB + g * kCols;
#pragma unroll
    for (int k = 0; k < kCols; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xg + k);
      u.xv[k] = v.x;
      u.xv[k + 1] = v.y;
      u.xv[k + 2] = v.z;
      u.xv[k + 3] = v.w;
    }
  }
}

// the thread's columns of unit u's x block into the lanes' shared x
// blocks (column-major: each lane reads its own bank)
__device__ __forceinline__ void stage_x(float* xs, int t, int g,
                                        const Unit& u) {
  if (u.xloc >= 0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) xs[(g * kCols + k) * kT + t] = u.xv[k];
  }
}

// Val: the plan's value type (float or bf16); x, y and the sums are f32
template <typename Val>
__global__ void __launch_bounds__(kThreads, kMaxBlocks)
sparse_ring_kernel(const Val* __restrict__ val, const int* __restrict__ meta,
                   const int* __restrict__ pb, const int* __restrict__ cw,
                   const float* __restrict__ x, float* __restrict__ y,
                   int nchunks, int width, int meta_rows, int k_panels,
                   int c_batch, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* xs = reinterpret_cast<float*>(smem + kXsOff);
  float* ys = reinterpret_cast<float*>(smem + kYsOff);
  unsigned* hs = reinterpret_cast<unsigned*>(smem + kHsOff);
  unsigned* grp = reinterpret_cast<unsigned*>(smem + kGrpOff);
  int* rows = reinterpret_cast<int*>(smem + kRowsOff);
  unsigned char* ring = smem + kFixedBytes;
  const unsigned vbytes = width * kT * sizeof(Val);
  const unsigned mbytes = (2 + width / 8 + 4) * kT * 4;
  const unsigned sbytes = vbytes + mbytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    // the producer: a stage refilled as soon as its consumers release it
    if (threadIdx.x == kConsumers) {
      uint64_t policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                   : "=l"(policy));
      int j = 0;
      for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++j) {
        const int st = j % stages;
        if (j >= stages) mbar_wait(empty + st, (j / stages - 1) & 1);
        unsigned char* dst = ring + st * sbytes;
        mbar_expect_tx(full + st, sbytes);
        bulk_copy(dst, val + (long long)c * width * kT, vbytes, full + st,
                  policy);
        bulk_copy(dst + vbytes, meta + (long long)c * meta_rows * kT, mbytes,
                  full + st, policy);
      }
    }
    return;
  }
  const int t = threadIdx.x % kT;
  const int g = threadIdx.x / kT;   // rows g*kRows .. g*kRows + kRows-1
  const int lane = threadIdx.x % 32;
  const int lg = t / 32;            // the lane group: lanes 32*lg ..
  const int gt = g * 32 + lane;     // the thread's place in its lane group
  // units j and j + 1 of the block
  Unit cur, next;
  cur.c = blockIdx.x;
  unit_head(cur, 0, stages, ring, sbytes, vbytes, full, pb, cw, x, k_panels,
            c_batch, t, g, lane);
  stage_x(xs, t, g, cur);
  group_sync(lg);
  for (int j = 0;; ++j) {
    const int st = j % stages;
    next.c = cur.c + gridDim.x;
    const bool more = next.c < nchunks;
    const bool active = cur.xloc >= 0;
    const Val* vs = reinterpret_cast<const Val*>(ring + st * sbytes) + t;
    const int* ms = reinterpret_cast<const int*>(ring + st * sbytes + vbytes)
                    + t;
    // the thread's rows, each summing its own slots in slot order
    const int* rw = ms + (2 + width / 8) * kT;
    const int* colw = ms + 2 * kT;
    const float* xb = xs + t;
    int end[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      end[i] = active ? rend_at(rw, g * kRows + i) : 0;
    }
    int lo = active && g > 0 ? rend_at(rw, g * kRows - 1) + 1 : 1;
    float sum[kRows];
    unsigned has = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float acc = 0.f;
      for (int s = lo; s <= end[i]; ++s) {
        const int col = static_cast<int>(
            static_cast<unsigned>(colw[(s >> 3) * kT]) >> ((s & 7) * 4) & 15u);
        acc = fmaf(tsp::to_acc(vs[s * kT]), xb[col * kT], acc);
      }
      sum[i] = acc;
      has |= static_cast<unsigned>(end[i] >= lo) << i;
      lo = end[i] + 1;
    }
    // the stage is read: release it to the producer, then the next unit's
    // head (its x loads in flight through this unit's flush)
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (more) {
      unit_head(next, j + 1, stages, ring, sbytes, vbytes, full, pb, cw, x,
                k_panels, c_batch, t, g, lane);
    }
    // the lane's sums, its rows with entries and its warp's lanes on the
    // same tile row, for the flush
#pragma unroll
    for (int i = 0; i < kRows; i += 4) {
      *reinterpret_cast<float4*>(ys + t * kB + g * kRows + i) =
          make_float4(sum[i], sum[i + 1], sum[i + 2], sum[i + 3]);
    }
    hs[g * kT + t] = has;
    if (g == 0) {
      const unsigned members =
          __match_any_sync(0xffffffffu, active ? cur.lrow : -1 - lane);
      grp[t] = active ? members : 0u;
      rows[t] = cur.lrow;
    }
    group_sync(lg);
    // the flush, 4 rows a thread, neighbouring threads on a tile row's 16:
    // the first lane of a warp's lanes on one tile row adds their sums
    // (its own, then the others in lane order) into y, one atomic a 4
    // rows that hold entries
    for (int e = gt; e < 32 * kB / 4; e += 32 * kRowGroups) {
      const int l = lg * 32 + (e >> 2);
      const int q = e & 3;
      const unsigned m = grp[l];
      if (!m || __ffs(m) - 1 != (l & 31)) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      unsigned bits = 0;
      for (unsigned mm = m; mm; mm &= mm - 1) {
        const int src = lg * 32 + __ffs(mm) - 1;
        const float4 v =
            *reinterpret_cast<const float4*>(ys + src * kB + q * 4);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
        bits |= hs[q * 4 / kRows * kT + src] >> (q * 4 % kRows) & 15u;
      }
      if (!bits) continue;
      atomicAdd(reinterpret_cast<float4*>(
                    y + ((long long)cur.win * 256 + rows[l]) * kB + q * 4),
                acc);
    }
    if (!more) break;
    // the next unit's x block: its readers and the flush's are past the
    // barrier above and the one below
    stage_x(xs, t, g, next);
    group_sync(lg);
    cur = next;
  }
}

constexpr int kMaxDevices = 64;

// per device: its SMs and shared memory, read once; the kernel opted in to
// the most shared memory a block may take
struct DeviceState {
  int sms = 0, smem_sm = 0, smem_block = 0, reserved = 0;
};

template <typename Val>
int device_state(DeviceState** out) {
  static DeviceState states[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceState& d = states[dev];
  if (d.sms == 0) {
    DeviceState n;
    if ((err = cudaDeviceGetAttribute(&n.smem_sm,
             cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) ||
        (err = cudaDeviceGetAttribute(&n.smem_block,
             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaDeviceGetAttribute(&n.reserved,
             cudaDevAttrReservedSharedMemoryPerBlock, dev)) ||
        (err = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) ||
        (err = cudaFuncSetAttribute(
             sparse_ring_kernel<Val>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, n.smem_block))) {
      return static_cast<int>(err);
    }
    d = n;
  }
  *out = &d;
  return 0;
}

struct Ring {
  int stages, blocks;   // stages a block, blocks an SM
};

// the ring for a stage of `sbytes`: the most blocks an SM (up to
// kMaxBlocks, whose registers __launch_bounds__ reserves) whose shared
// memory holds two stages each, with as many stages (up to kMaxStages) as
// fit; else one block, of as many stages as fit (0: not even one)
Ring ring_stages(const DeviceState& d, long long sbytes) {
  for (int b = kMaxBlocks; b >= 1; --b) {
    long long room = d.smem_sm / b - d.reserved;
    if (room > d.smem_block) room = d.smem_block;
    const long long n = (room - kFixedBytes) / sbytes;
    if (n >= 2 || b == 1) {
      return {static_cast<int>(n < kMaxStages ? n : kMaxStages), b};
    }
  }
  return {0, 0};
}

// values, meta, x and y 16-byte aligned (bulk copies, float4 loads and
// atomics), as torch allocates them
template <typename Val>
int launch(const Val* val, const int* meta, const int* pb, const int* cw,
           const float* x, float* y, int nchunks, int width, int t_lanes,
           int meta_rows, int k_panels, int c_batch, void* stream) {
  if (width < 8 || width > kMaxW || width % 8 || t_lanes != kT ||
      meta_rows < 2 + width / 8 + 4 || k_panels < 1 || k_panels > kMaxK ||
      c_batch < 1 || reinterpret_cast<uintptr_t>(val) % 16 ||
      reinterpret_cast<uintptr_t>(meta) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    DeviceState* d = nullptr;
    if (int err = device_state<Val>(&d)) return err;
    const long long sbytes =
        (long long)width * kT * sizeof(Val) + (2 + width / 8 + 4) * kT * 4;
    const Ring ring = ring_stages(*d, sbytes);
    if (ring.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kFixedBytes + ring.stages * static_cast<int>(sbytes);
    const long long most = (long long)ring.blocks * d->sms;
    const int grid = static_cast<int>(nchunks < most ? nchunks : most);
    sparse_ring_kernel<Val><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        val, meta, pb, cw, x, y, nchunks, width, meta_rows, k_panels,
        c_batch, ring.stages);
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
