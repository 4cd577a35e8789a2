"""Entry-level stream engine plan for very sparse tiles (the COO class).

NumPy port of tilespmv_tpu/ops/pallas/stream_plan.py, held bit-equal
to it by tests/test_torch_plan.py (f32) and tests/test_torch_f64_plan.py
(f64). The layout is the reference package's; this module only builds
it, as NumPy arrays.

* a **slab** is an (8, 128) block of nonzero entries belonging to one
  output window (1024 rows) and one aligned x *superspan* of
  `span_rows` x 128 values: sublane q holds entries whose column falls
  in the superspan's q-th block, sorted by row, lane 0 reserved zero;
* `vidx` (int16) is the entry's column within its sublane's block
  (row-of-128 << 7 | lane); bit 13 marks a dual-span slab's second
  superspan (`sbase2`);
* the y scatter is a per-sublane inclusive prefix over lanes plus
  plan-time int8 planes, in one of three encodings (the `scatter`
  field, which the reference's STREAM_SCATTER picks; the entries, their
  placement and every other array are the same in all three):
  - "rounds" (the only one this package builds): per round t, target (q, j) of the window
    takes csum[src, rend[src, j]] - csum[src, rstart[src, j]] with
    src = rsrc[q, j]. Runs are split into rounds by the proper edge
    coloring (src_sublane + target_sublane) % 8 of each (slab, lane)
    cell, so a round never has two runs on one target;
  - "offs": run j of sublane s ends at lane ue[s, j] and starts after
    us[s, j]; g_d[s, l] = j routes that run to cell ((s + d) % 8, l) for
    each static sublane offset d (OFFS_SLAB_ROWS a slab);
  - "roll": ue_d[s, l] and us_d[s, l] bound the run of sublane s that
    goes to cell ((s + d) % 8, l) (ROLL_SLAB_ROWS a slab);
* `erow` (this package only, `entry_rows`) holds the same routing per
  entry slot: its output row in the window, which the H100 stream
  kernels read instead of the planes. It is derived from the planes of
  any encoding and comes out the same in all three;
* free-placement classes (`xmap`) drop the span alignment: each of a
  slab's 8 sublane slots maps to an arbitrary 1024-value x block of
  the window, x row = xmap[slab*64 + chunk*8 + sublane].

f64 plans (`compute_dtype=np.float64`) have the f32 layout with float64
values: each value is the reference's double-f32 pair summed in f64,
hi + lo with hi = f32(v) and lo = f32(v - hi) (`f64_plan_value`), so
they stay bit-checkable against the reference's `val` + `val_lo`. The
reference's segmented-scan planes (`segmask`) feed only its compiled
double-f32 scan and are not built; the round planes are the same in
both dtypes.

bf16 plans (lane_plan.as_bf16) are the f32 plan with each value
rounded to bfloat16 as the reference rounds it (f64 -> f32 -> bf16, each
to nearest even; `bf16_bits`). NumPy has no bfloat16, so their value
arrays hold the bit patterns as uint16 (BF16_BITS); the torch side views
them as torch.bfloat16 (reference.plan_tensor).

The builders emit rounds planes only. Offs and roll planes come in
through plan files and plans the reference writes (interop,
core/serialize.py): `entry_rows` reads the planes of each encoding, and
the plain versions on the CPU and the stream kernels on the card read
`erow` alone, so such a plan runs through the same code as a rounds
plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

RW_ROWS = 1024     # y rows per output window: (8 sublanes) x (128 lanes)
LANES = 128
SUBS = 8
CAP = LANES - 1    # usable entry lanes per sublane (lane 0 reserved)
ROUNDS = 8         # modular (src+tgt)%8 coloring: always exactly 8
XBLOCK_ROWS = 8    # x2d128 rows per sublane's x window (1024 values)
SPAN_ROWS = 64     # default x2d128 rows per slab superspan (8 windows)
SPAN_CHOICES = (64, 128, 256, 512)
MAX_SPAN_ROWS = SPAN_CHOICES[-1]  # x padding slack past the end
EROW_PAD = -1      # StreamChunks.erow of a slot that holds no entry
# y-scatter encodings of the reference's planes (see the module doc)
SCATTERS = ("rounds", "offs", "roll")
# int8 plane rows per slab of the offs encoding: [ue(8) | us(8) |
# g_0..g_7 (64)] = 80 rows, padded to 96 as the reference pads them
OFFS_SLAB_ROWS = 96
# ... and of the roll encoding: [ue_d0(8) us_d0(8) ue_d1(8) ... us_d7(8)]
ROLL_SLAB_ROWS = 128
# a bf16 plan's compute dtype, and the NumPy dtype of its values' bits
BF16 = "bfloat16"
BF16_BITS = np.dtype(np.uint16)


def is_bf16(dt) -> bool:
    """True for bfloat16 by any of its names: BF16, the reference's NumPy
    bfloat16, torch.bfloat16."""
    return str(dt).removeprefix("torch.") == BF16


def bf16_bits(v) -> np.ndarray:
    """The bfloat16 bit patterns (BF16_BITS) of `v` rounded as the
    reference's `astype(jnp.bfloat16)` rounds float64: to float32, then
    to bfloat16, each to nearest even; NaN becomes the quiet NaN of its
    sign."""
    f = np.asarray(v).astype(np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    r = np.where(np.isnan(f), (u >> 16) & 0x8000 | 0x7FC0, r)
    return r.astype(BF16_BITS)


def bf16_values(cls):
    """Plan class `cls` (NumPy arrays, f32 values) with its `val` as
    bf16_bits; None for None."""
    if cls is None:
        return None
    return dataclasses.replace(cls, val=bf16_bits(cls.val))


def f64_plan_value(v: np.ndarray) -> np.ndarray:
    """The value an f64 plan holds for f64 `v`: the reference's exact
    double-f32 pair (hi = f32(v), lo = f32(v - hi)) summed in float64,
    which represents hi + lo exactly (48 significant bits)."""
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi.astype(np.float64) + lo.astype(np.float64)


# int8 plane rows per slab in the RAW (builder) layout: R rounds x
# [rend | rstart | rsrc] x 8 sublanes (rows t*24 + {0,8,16} + s)
def plane_rows(rounds: int) -> int:
    return rounds * 3 * SUBS


# int8 plane rows per STEP in the stacked (kernel) layout: for each
# round t, all s_batch slabs' rend planes (S*8 rows), then all rstart,
# then all rsrc
def step_plane_rows(rounds: int, s_batch: int) -> int:
    return rounds * 3 * SUBS * s_batch


def stack_step_planes(planes: np.ndarray, s_batch: int,
                      rounds: int) -> np.ndarray:
    """(nslabs, plane_rows(R), 128) raw per-slab planes -> per-step
    stacked (nsteps, step_plane_rows(R, S), 128)."""
    nslabs = planes.shape[0]
    nsteps = nslabs // s_batch
    p = planes.reshape(nsteps, s_batch, rounds, 3, SUBS, LANES)
    return np.ascontiguousarray(p.transpose(0, 2, 3, 1, 4, 5)).reshape(
        nsteps, step_plane_rows(rounds, s_batch), LANES)


def scatter_slab_rows(scatter: str) -> int:
    """Plane rows per slab of the offs or roll encoding."""
    return OFFS_SLAB_ROWS if scatter == "offs" else ROLL_SLAB_ROWS


def step_rows(scatter: str, rounds: int, s_batch: int) -> int:
    """Plane rows per step of a class of encoding `scatter`."""
    if scatter == "rounds":
        return step_plane_rows(rounds, s_batch)
    if scatter not in SCATTERS:
        raise ValueError(f"scatter {scatter!r}: one of {SCATTERS}")
    return scatter_slab_rows(scatter) * s_batch


@dataclasses.dataclass(frozen=True)
class StreamChunks:
    """Entry-level slabs: (nslabs, 8, 128) value/index planes, processed
    `s_batch` per step; every step's slabs share one output window.
    `cw`, `cfirst` and `sactive` are per step; `sbase`/`sbase2` per
    slab."""
    val: Any      # (nslabs, 8, 128) f32, or f64 (f64_plan_value)
    vidx: Any     # (nslabs, 8, 128) int16: row-of-128<<7 | lane
    planes: Any   # (nsteps, step_rows(scatter, R, S), 128) int8
    sbase: Any    # (nslabs,) int32: x2d128 row base of the superspan
    cw: Any       # (nsteps,) int32: output window id
    cfirst: Any   # (nsteps,) int32: 1 = first step of its window
    sactive: Any  # (nsteps,) int32: 0 = every slab in the step is empty
    sbase2: Any = None  # (nslabs,) int32, dual-span classes only
    xmap: Any = None    # (nslabs*64,) int32, free-placement classes only
    # (nslabs, 8, 128) int16: each entry slot's output row in its step's
    # window (q*128 + j), EROW_PAD on padding slots and lane 0; derived
    # from the planes by entry_rows (the reference has no such field)
    erow: Any = None

    s_batch: int = 4
    rounds_: int = ROUNDS
    span_rows: int = SPAN_ROWS
    dual: bool = False
    # y-scatter encoding of `planes`: "rounds", "offs" or "roll"
    scatter: str = "rounds"

    @property
    def nslabs(self) -> int:
        return self.val.shape[0]

    @property
    def nsteps(self) -> int:
        return self.cw.shape[0]

    @property
    def rounds(self) -> int:
        return self.rounds_


def empty_stream_chunks(n_windows: int, compute_dtype=np.float32,
                        s_batch: int = 4, rounds: int = 4) -> StreamChunks:
    """All-inert slabs, one step of `s_batch` slabs per window (every
    step inactive, every `erow` EROW_PAD): the stream class of a plan
    forced into the stream engine with no entries for it (the
    reference's `empty_stream_chunks`; `compute_dtype` float32 or
    float64)."""
    ns = n_windows * s_batch
    return with_entry_rows(StreamChunks(
        val=np.zeros((ns, SUBS, LANES), np.dtype(compute_dtype)),
        vidx=np.zeros((ns, SUBS, LANES), np.int16),
        planes=np.zeros((n_windows, step_plane_rows(rounds, s_batch),
                         LANES), np.int8),
        sbase=np.zeros(ns, np.int32),
        cw=np.arange(n_windows, dtype=np.int32),
        cfirst=np.ones(n_windows, np.int32),
        sactive=np.zeros(n_windows, np.int32),
        s_batch=s_batch, rounds_=rounds))


# Cost-model constants of the reference planner (measured there on its
# own device). The port keeps them unchanged so its plans stay identical
# to the reference's; re-fitting them for the H100 is later work.
SLAB_NS = {1: 146.6, 2: 113.0, 4: 90.6, 8: 87.2, 16: 77.8}
STEP_NS = 267.0
SKIP0_NS = 179.0
SKIP_SLOT_NS = 47.5
S_MAX = 16
# second stream dispatch + scheduling slack when the class is split into
# a (base, heavy) pair (see split_stream_chunks)
EXTRA_CLASS_NS = 4000.0
# per-slab decomposition: fixed work + x staging per (span_rows/8) chunk
SLAB_FLOOR_NS = 83.0
STAGE_CHUNK_NS = 2.3
DUAL_EXTRA_CHUNK_NS = 1.4
# free-placement margin (see pick_geometry_fp)
FP_MARGIN = 0.8


def skip_ns(s: int) -> float:
    """Cost of one skipped step at `s` slabs/step."""
    return SKIP0_NS + SKIP_SLOT_NS * s


def slab_ns(s: int) -> float:
    """Per-slab cost at `s` slabs per step: the power-of-2 anchors
    (SLAB_NS) log2-interpolated. Mirrored in native/streamplan.cpp."""
    ks = sorted(SLAB_NS)
    return float(np.interp(np.log2(s), np.log2(ks),
                           [SLAB_NS[k] for k in ks]))


def _window_costs(counts: np.ndarray, s: int) -> np.ndarray:
    """Per-window cost at s slabs/step: ceil(c/s) steps, each paying the
    step cost plus s slab slots; empty windows one skipped step."""
    return np.where(
        counts == 0, skip_ns(s),
        (-(-counts // s)).astype(np.float64) * (STEP_NS + s * slab_ns(s)))


def pick_s_batch(wcnt: np.ndarray) -> int:
    """Cost-minimizing slabs-per-step over the per-window slab counts."""
    counts = np.asarray(wcnt, np.int64)
    best, best_cost = 1, None
    for s in range(1, S_MAX + 1):
        cost = float(_window_costs(counts, s).sum())
        if best_cost is None or cost < best_cost * 0.98:
            best, best_cost = s, cost
    return best


def pick_stream_split(wcnt: np.ndarray):
    """Two-class slabs-per-step choice over the per-window slab counts.

    Returns (s_base, s_heavy | None, heavy_mask | None). Each window
    joins whichever class is cheaper for it; the best (s_base, s_heavy)
    pair must beat the best single class by EXTRA_CLASS_NS plus 2%."""
    counts = np.asarray(wcnt, np.int64)
    cost = {s: _window_costs(counts, s) for s in range(1, S_MAX + 1)}
    s_single = min(cost, key=lambda s: cost[s].sum())
    best = (float(cost[s_single].sum()), s_single, None, None)
    for s1 in range(1, S_MAX + 1):
        for s2 in range(s1 + 1, S_MAX + 1):
            heavy = cost[s2] < cost[s1]
            if not heavy.any() or heavy.all():
                continue
            tot = (float(np.where(heavy, cost[s2], cost[s1]).sum())
                   + EXTRA_CLASS_NS)
            if tot < best[0] * 0.98:
                best = (tot, s1, s2, heavy)
    return best[1], best[2], best[3]


def _occupied_cells(g_row: np.ndarray, g_col: np.ndarray):
    """Occupied (window, 1024-col block) cells with entry counts — the
    one O(nz log nz) pass every geometry candidate aggregates from."""
    q = (g_col >> 10).astype(np.int64)
    nq = int(q.max()) + 1
    uk, uc = np.unique((g_row >> 10).astype(np.int64) * nq + q,
                       return_counts=True)
    return uk // nq, uk % nq, uc, nq


def _group_counts_cells(uw, uq, uc, nq, r: int):
    """Per-(window, superspan) group sublane histograms at span width
    `r` from the occupied cells. Returns (C (G, 8) int64 counts, gwin
    (G,) window ids) in (window, span) order."""
    g = r // 64
    gkey = (uw * nq + (uq // (8 * g)) * (8 * g)) * 8 + (uq // g) % 8
    gk8, inv = np.unique(gkey, return_inverse=True)
    c8 = np.bincount(inv, weights=uc).astype(np.int64)
    ug, ginv = np.unique(gk8 // 8, return_inverse=True)
    C = np.zeros((ug.size, SUBS), np.int64)
    C[ginv, gk8 % 8] = c8
    return C, (ug // nq).astype(np.int64)


def _dual_slab_count(C: np.ndarray, gwin: np.ndarray) -> int:
    """Slab count of the sequential dual-span greedy packing (the same
    walk _build_dual performs), from group histograms alone."""
    total = 0
    L = np.zeros(SUBS, np.int64)
    prev_w = -1
    for i in range(C.shape[0]):
        w = int(gwin[i])
        if w != prev_w:
            if L.any():
                total += 1
            L[:] = 0
            prev_w = w
        c = C[i].copy()
        if L.any():
            c -= np.minimum(c, CAP - L)
            total += 1
            L[:] = 0
        mx = int(c.max())
        kf = max(0, -(-mx // CAP) - 1) if mx else 0
        total += kf
        L = np.clip(c - kf * CAP, 0, None)
    if L.any():
        total += 1
    return total


def _fp_cost(cells) -> tuple[float, np.ndarray]:
    """Free-placement cost model from occupied (window, 1024-block)
    cells. Returns (cost_ns, per-window slab counts)."""
    uw, uq, uc, nq = cells
    slots_per_cell = -(-uc // CAP)
    nwin = int(uw.max()) + 1 if uw.size else 1
    wslots = np.zeros(nwin, np.int64)
    np.add.at(wslots, uw, slots_per_cell)
    wslabs = -(-wslots // SUBS)
    slabs = int(wslabs.sum())
    kernel_ns = slabs * (SLAB_FLOOR_NS + STAGE_CHUNK_NS * SUBS)
    xcopy_ns = slabs * SPAN_ROWS * LANES * 4 * 2 / 800.0
    return kernel_ns + xcopy_ns, wslabs


def pick_geometry_fp(g_row: np.ndarray, g_col: np.ndarray, m: int,
                     cells=None):
    """(span_rows, dual, fp): the aligned pick plus the free-placement
    candidate, which must beat the aligned winner by FP_MARGIN."""
    if cells is None:
        cells = _occupied_cells(g_row, g_col)
    span, dual = pick_geometry(g_row, g_col, m, cells=cells)
    C, gwin = _group_counts_cells(*cells, span)
    if dual:
        slabs = _dual_slab_count(C, gwin)
    else:
        slabs = int((-(-C.max(axis=1) // CAP)).sum())
    stage = STAGE_CHUNK_NS * (span // 8) + (
        DUAL_EXTRA_CHUNK_NS * (span // 8) if dual else 0.0)
    aligned_cost = slabs * (SLAB_FLOOR_NS + stage)
    fp_ns, _ = _fp_cost(cells)
    return span, dual, bool(fp_ns < FP_MARGIN * aligned_cost)


def pick_geometry(g_row: np.ndarray, g_col: np.ndarray, m: int,
                  cells=None):
    """Jointly pick (span_rows, dual) by the slab cost model. A
    non-default span must beat the 64-row default by >5%; dual at the
    default span wins plain ties."""
    best, best_cost, cost_default = (SPAN_CHOICES[0], False), None, None
    uw, uq, uc, nq = (cells if cells is not None
                      else _occupied_cells(g_row, g_col))
    for r in SPAN_CHOICES:
        C, gwin = _group_counts_cells(uw, uq, uc, nq, r)
        s_mono = int((-(-C.max(axis=1) // CAP)).sum())
        cands = [(False, s_mono)]
        # dual never helps when mono fill is already high
        if g_row.size < 0.92 * s_mono * SUBS * CAP:
            cands.append((True, _dual_slab_count(C, gwin)))
        for dual, slabs in cands:
            stage = STAGE_CHUNK_NS * (r // 8) + (
                DUAL_EXTRA_CHUNK_NS * (r // 8) if dual else 0.0)
            cost = slabs * (SLAB_FLOOR_NS + stage)
            if cost_default is None:
                cost_default = cost
            margin = 1.0 if (dual and r == SPAN_CHOICES[0]) else 0.95
            if best_cost is None or (cost < best_cost
                                     and cost < cost_default * margin):
                best, best_cost = (r, dual), cost
    return best


def pick_span_rows(g_row: np.ndarray, g_col: np.ndarray, m: int) -> int:
    """Cost-minimizing superspan width for this entry population, for a
    layout whose dual choice is given. Wider spans merge (window, span)
    groups (fewer, fuller slabs) at STAGE_CHUNK_NS a slab per extra x
    chunk; a group's slab count is the max over its 8 sublanes of
    ceil(count / CAP). A wider span must beat the default span's cost by
    more than 5% to displace it."""
    uw, uq, uc, nq = _occupied_cells(g_row, g_col)
    best, best_cost = SPAN_CHOICES[0], None
    cost_default = None
    for r in SPAN_CHOICES:
        C, _ = _group_counts_cells(uw, uq, uc, nq, r)
        slabs = int((-(-C.max(axis=1) // CAP)).sum())
        cost = slabs * (SLAB_FLOOR_NS + STAGE_CHUNK_NS * (r // 8))
        if cost_default is None:
            cost_default = cost
        if best_cost is None or (cost < best_cost
                                 and cost < cost_default * 0.95):
            best, best_cost = r, cost
    return best


def _runs_planes(slab_of: np.ndarray, sub_of: np.ndarray,
                 lane_of: np.ndarray, r: np.ndarray, nslabs: int):
    """Round planes from entry placements. Entries must arrive
    (slab, sublane)-contiguous and row-sorted within each (slab,
    sublane); lane 0 is reserved. Returns (planes_raw, rounds)."""
    nz = r.shape[0]
    skey = slab_of * SUBS + sub_of
    newrun = np.ones(nz, bool)
    newrun[1:] = (skey[1:] != skey[:-1]) | (r[1:] != r[:-1])
    runs = np.nonzero(newrun)[0]
    run_end_e = np.append(runs[1:], nz) - 1

    c_slab = slab_of[runs]
    c_src = sub_of[runs]
    c_row = r[runs]
    c_start = lane_of[runs] - 1          # exclusive (>= 0: lane 0 pad)
    c_end = lane_of[run_end_e]           # inclusive
    rloc = c_row - (c_row >> 10 << 10)
    c_tgt = (rloc >> 7).astype(np.int64)
    c_j = rloc & (LANES - 1)
    color = ((c_src + c_tgt) % SUBS).astype(np.uint8)
    used = np.zeros((nslabs, LANES), np.uint8)
    np.bitwise_or.at(used, (c_slab, c_j), np.uint8(1) << color)
    pop = np.array([bin(m_).count("1") for m_ in range(256)], np.int64)
    below = (used[c_slab, c_j]
             & ((np.uint16(1) << color) - 1).astype(np.uint8))
    t = pop[below]
    rounds = max(4, int(-(-(int(t.max()) + 1) // 4) * 4)) if t.size else 4

    planes = np.zeros((nslabs, plane_rows(rounds), LANES), np.int8)
    planes[c_slab, t * 3 * SUBS + c_src, c_j] = c_end.astype(np.int8)
    planes[c_slab, t * 3 * SUBS + SUBS + c_src, c_j] = c_start.astype(
        np.int8)
    # default rsrc: point every (t, q, j) at a source sublane with no
    # contributor there (zero diff), then overwrite the routed targets
    busybits = np.zeros((nslabs, rounds, LANES), np.uint8)
    np.bitwise_or.at(busybits, (c_slab, t, c_j),
                     (1 << c_src).astype(np.uint8))
    lut = np.zeros(256, np.int8)
    for mask in range(255):
        lut[mask] = next(s_ for s_ in range(SUBS) if not (mask >> s_) & 1)
    first_free = lut[busybits]                    # (nslabs, R, 128)
    for tt in range(rounds):
        base = tt * 3 * SUBS + 2 * SUBS
        planes[:, base: base + SUBS, :] = first_free[:, tt, None, :]
    planes[c_slab, t * 3 * SUBS + 2 * SUBS + c_tgt, c_j] = (
        c_src.astype(np.int8))
    return planes, rounds


def _plane_runs(st: StreamChunks):
    """Every run the stacked planes of `st` route: (slab, src sublane,
    start - 1 lane, end lane, output row q*128 + j) arrays."""
    S, R = st.s_batch, st.rounds
    nsteps = st.cw.shape[0]
    nsl = nsteps * S
    planes = np.asarray(st.planes)
    tgt = np.arange(SUBS)[None, :, None]
    parts = []       # (rend, rstart, src, row) planes per round or offset
    if st.scatter == "rounds":
        p = planes.reshape(nsteps, R, 3, S, SUBS, LANES)
        for t in range(R):
            rend, rstart, rsrc = (p[:, t, c].reshape(nsl, SUBS, LANES)
                                  for c in range(3))
            src = rsrc.astype(np.intp)
            parts.append((np.take_along_axis(rend, src, axis=1),
                          np.take_along_axis(rstart, src, axis=1), src,
                          np.broadcast_to(tgt, src.shape)))
    else:
        p = planes.reshape(nsl, scatter_slab_rows(st.scatter), LANES)
        src = np.broadcast_to(np.arange(SUBS)[None, :, None],
                              (nsl, SUBS, LANES))
        for d in range(SUBS):
            if st.scatter == "offs":
                g = p[:, 2 * SUBS + d * SUBS:3 * SUBS + d * SUBS].astype(
                    np.intp)
                rend = np.take_along_axis(p[:, :SUBS], g, axis=2)
                rstart = np.take_along_axis(p[:, SUBS:2 * SUBS], g, axis=2)
            else:
                rend = p[:, 2 * SUBS * d:2 * SUBS * d + SUBS]
                rstart = p[:, 2 * SUBS * d + SUBS:2 * SUBS * (d + 1)]
            parts.append((rend, rstart, src, (src + d) % SUBS))
    runs = []
    lane = np.arange(LANES)
    for rend, rstart, src, q in parts:
        hit = rend > rstart
        sl, a, j = np.nonzero(hit)
        runs.append((sl, src[hit], rstart[hit].astype(np.int64),
                     rend[hit].astype(np.int64),
                     q[hit] * LANES + lane[j]))
    return [np.concatenate(a) for a in zip(*runs)]


def entry_rows(st: StreamChunks) -> np.ndarray:
    """Each entry slot's output row in its step's 1024-row window, from
    the stacked planes of any encoding: a run of lanes (start, end] of
    sublane src routed to target (q, j) gives those lanes row q*128 + j.
    (nslabs, 8, 128) int16, EROW_PAD where no run lies (lane 0,
    padding). Rows are non-decreasing along each sublane's entries,
    since the builders sort them so; the encodings route the same runs,
    so they give the same rows."""
    nsl = st.cw.shape[0] * st.s_batch
    sl, src, s, e, row = _plane_runs(st)
    n = e - s
    first = np.repeat(np.cumsum(n) - n, n)
    lane = np.repeat(s + 1, n) + np.arange(int(n.sum())) - first
    erow = np.full((nsl, SUBS, LANES), EROW_PAD, np.int16)
    erow[np.repeat(sl, n), np.repeat(src, n), lane] = np.repeat(row, n)
    return erow


def with_entry_rows(st: Optional[StreamChunks]) -> Optional[StreamChunks]:
    """`st` (stacked planes) with its `erow` field; None for None."""
    if st is None:
        return None
    return dataclasses.replace(st, erow=entry_rows(st))


def _rank_within(key: np.ndarray) -> np.ndarray:
    """0-based rank of each element within its equal-key group."""
    n = key.shape[0]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new = np.ones(n, bool)
    new[1:] = ks[1:] != ks[:-1]
    startpos = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    rk = np.empty(n, np.int64)
    rk[order] = np.arange(n) - startpos
    return rk


def split_stream_chunks(st: StreamChunks):
    """Re-batch a built stream class, its planes still in the RAW
    per-slab layout, into a (base, heavy) pair when the cost model says
    two slabs-per-step rates beat one. The two classes' window sets are
    DISJOINT. Returns (base, heavy | None) with stacked planes."""
    def _as_built(sc):
        return with_entry_rows(dataclasses.replace(
            sc, planes=stack_step_planes(sc.planes, sc.s_batch,
                                         sc.rounds_)))

    S0, R = st.s_batch, st.rounds_
    cw = st.cw
    n_windows = int(cw[-1]) + 1
    val = st.val
    nslabs = val.shape[0]
    load = np.count_nonzero(val.reshape(nslabs, -1), axis=1)
    win_of_slab = np.repeat(cw.astype(np.int64), S0)
    real = load > 0
    wcnt = np.bincount(win_of_slab[real], minlength=n_windows)
    s1, s2, heavy = pick_stream_split(wcnt)
    if s2 is None and s1 == S0:
        return _as_built(st), None
    if s2 is None:
        heavy = np.zeros(n_windows, bool)

    vidx, sbase, sbase2 = st.vidx, st.sbase, st.sbase2
    xmap = st.xmap.reshape(-1, SPAN_ROWS) if st.xmap is not None else None

    def build(wmask, s):
        sel_w = np.nonzero(wmask)[0]
        cnt = wcnt[sel_w]
        padded = np.maximum(1, -(-cnt // s)) * s
        starts = np.concatenate([[0], np.cumsum(padded)])[:-1]
        tot = int(padded.sum())
        v = np.zeros((tot, SUBS, LANES), val.dtype)
        vi = np.zeros((tot, SUBS, LANES), np.int16)
        pr = np.zeros((tot, plane_rows(R), LANES), np.int8)
        sb = np.zeros(tot, np.int32)
        sb2 = np.zeros(tot, np.int32) if sbase2 is not None else None
        xm = (np.zeros((tot, SPAN_ROWS), np.int32)
              if xmap is not None else None)
        ld = np.zeros(tot, np.int64)
        sel_slab = real & wmask[win_of_slab]
        idx = np.nonzero(sel_slab)[0]        # window-major, load-sorted
        if idx.size:
            w_of = win_of_slab[idx]
            dst = starts[np.searchsorted(sel_w, w_of)] + _rank_within(w_of)
            v[dst] = val[idx]
            vi[dst] = vidx[idx]
            pr[dst] = st.planes[idx]
            sb[dst] = sbase[idx]
            if sb2 is not None:
                sb2[dst] = sbase2[idx]
            if xm is not None:
                xm[dst] = xmap[idx]
            ld[dst] = load[idx]
        win_full = np.repeat(sel_w, padded)
        cwc = win_full[::s].astype(np.int32)
        cf = np.ones(cwc.shape[0], np.int32)
        cf[1:] = (cwc[1:] != cwc[:-1]).astype(np.int32)
        sact = (ld.reshape(-1, s).sum(axis=1) > 0).astype(np.int32)
        if xm is not None:
            # free placement: span base is slab * SPAN_ROWS in the
            # class's own x copy
            sb = np.arange(tot, dtype=np.int32) * SPAN_ROWS
        return with_entry_rows(StreamChunks(
            val=v, vidx=vi, planes=stack_step_planes(pr, s, R),
            sbase=sb, cw=cwc, cfirst=cf, sactive=sact, sbase2=sb2,
            xmap=xm.reshape(-1) if xm is not None else None,
            s_batch=s, rounds_=R, span_rows=st.span_rows, dual=st.dual))

    return build(~heavy, s1), (build(heavy, s2) if s2 is not None
                               else None)


def build_stream_chunks(g_row: np.ndarray, g_col: np.ndarray,
                        val: np.ndarray, m: int,
                        span_rows: Optional[int] = None,
                        stack: bool = True,
                        dual: Optional[bool] = None,
                        fp: Optional[bool] = None,
                        compute_dtype=np.float32,
                        s_batch: Optional[int] = None):
    """Compile a global COO entry list into stream slabs of
    `compute_dtype` values (float32, or float64 as f64_plan_value) —
    None for no entries; no entry ever spills: the modular coloring
    cannot conflict. With neither `span_rows` nor `dual` given,
    pick_geometry_fp chooses them and the free-placement layout (unless
    `fp` is given); with `dual` alone, pick_span_rows picks the span;
    `span_rows` alone builds the mono layout (dual False), not free
    placement, as the reference does. `s_batch` pins the slabs per step
    (None: pick_s_batch). `stack=False` keeps the round planes in the
    raw per-slab layout."""
    cdt = np.dtype(compute_dtype)
    f64 = cdt == np.dtype(np.float64)
    n_windows = max(1, -(-m // RW_ROWS))
    nz = g_row.shape[0]
    if nz == 0:
        return None
    if span_rows is None and dual is None:
        span_rows, dual, fp_pick = pick_geometry_fp(g_row, g_col, m)
        if fp is None:
            fp = fp_pick
    elif span_rows is None:
        span_rows = pick_span_rows(g_row, g_col, m)
    dual = bool(dual)
    if fp:
        return _build_fp(g_row, g_col, val, m, stack, cdt, s_batch)
    sh = 7 + int(span_rows).bit_length() - 1     # log2(span_rows * 128)
    vmask = 16 * span_rows - 1                   # sub-window col mask

    if dual:
        return _build_dual(g_row, g_col, val, m, span_rows, stack, cdt,
                           s_batch)

    from ...core import native
    raw = native.stream_plan(g_row, g_col, val, m, span_rows=span_rows,
                             want_lo=f64, s_batch=s_batch)
    if raw is not None:
        win_full = np.repeat(raw["cw"], raw["s_batch"])
        return _finish_stream(raw["val"], raw["vidx"], raw["planes"],
                              raw["sbase"], win_full, raw["s_batch"],
                              raw["rounds"], span_rows=span_rows,
                              stack=stack, val_lo_arr=raw.get("val_lo"))

    win = (g_row >> 10).astype(np.int64)
    span = (g_col >> sh).astype(np.int64)    # aligned superspan

    # --- per (window, superspan) group: sublane = 3 col bits below the
    # span, entries row-sorted within sublane, split at CAP; the group's
    # slab count is the max over its 8 sublanes ---
    order = np.argsort((win << 44) | (span << 24)
                       | ((g_col >> (sh - 3)) & 7) << 20
                       | (g_row & (RW_ROWS - 1)), kind="stable")
    r = g_row[order]
    c = g_col[order]
    v = val[order]
    win = win[order]
    span = span[order]
    sub_of = ((c >> (sh - 3)) & 7).astype(np.int64)

    gkey = win * (1 << 24) + span
    newg = np.ones(nz, bool)
    newg[1:] = gkey[1:] != gkey[:-1]
    gid = np.cumsum(newg) - 1                    # entry -> group
    ngroups = int(gid[-1]) + 1
    pis = _rank_within(gid * SUBS + sub_of)      # rank in (group, sublane)
    k = pis // CAP                               # slab-within-group
    lane_of = pis % CAP + 1                      # lane 0 reserved
    nsl_per_group = np.zeros(ngroups, np.int64)
    np.maximum.at(nsl_per_group, gid, k + 1)
    gslab_start0 = np.concatenate([[0], np.cumsum(nsl_per_group)])[:-1]
    gstart = np.nonzero(newg)[0]
    raw_win = np.repeat(win[gstart], nsl_per_group)
    raw_base = np.repeat(span[gstart] * span_rows, nsl_per_group)
    slab_raw = gslab_start0[gid] + k

    # --- pad each window's slab count to a multiple of s_batch ---
    wcnt = np.bincount(raw_win, minlength=n_windows)
    slabs_per_win = np.maximum(1, wcnt)
    if s_batch is None:
        s_batch = pick_s_batch(wcnt)
    slabs_pad = -(-slabs_per_win // s_batch) * s_batch
    slab_start = np.concatenate([[0], np.cumsum(slabs_pad)])[:-1]
    nslabs = int(slabs_pad.sum())
    old2new = slab_start[raw_win] + _rank_within(raw_win)
    slab_of = old2new[slab_raw]

    sbase = np.zeros(nslabs, np.int32)
    sbase[old2new] = raw_base.astype(np.int32)

    val_arr = np.zeros((nslabs, SUBS, LANES), cdt)
    vidx_arr = np.zeros((nslabs, SUBS, LANES), np.int16)
    val_arr[slab_of, sub_of, lane_of] = v
    vidx_arr[slab_of, sub_of, lane_of] = (c & vmask).astype(np.int16)
    planes, rounds = _runs_planes(slab_of, sub_of, lane_of, r, nslabs)

    win_arr = np.repeat(np.arange(n_windows), slabs_pad)
    return _finish_stream(val_arr, vidx_arr, planes, sbase, win_arr,
                          s_batch, rounds, span_rows=span_rows,
                          stack=stack)


def _build_fp(g_row, g_col, val, m, stack, cdt=np.dtype(np.float32),
              s_batch: Optional[int] = None) -> Optional[StreamChunks]:
    """Free-placement slabs: each of a slab's 8 sublane slots maps to
    an ARBITRARY (same-window) 1024-value x block via the plan-time
    xmap rows — no span alignment, so hypersparse populations pack at
    their per-cell ceiling."""
    n_windows = max(1, -(-m // RW_ROWS))
    nz = g_row.shape[0]
    if nz == 0:
        return None
    win = (g_row >> 10).astype(np.int64)
    blk = (g_col >> 10).astype(np.int64)
    order = np.lexsort((g_row, blk, win))
    r = g_row[order]
    c = g_col[order]
    v = val[order]
    win_o, blk_o = win[order], blk[order]

    ckey = win_o * (np.int64(1) << 34) + blk_o
    newc = np.ones(nz, bool)
    newc[1:] = ckey[1:] != ckey[:-1]
    cid = np.cumsum(newc) - 1
    rank_in_cell = _rank_within(cid)
    slot_in_cell = rank_in_cell // CAP
    lane_of = rank_in_cell % CAP + 1
    ccnt = np.bincount(cid)
    slots_per_cell = -(-ccnt // CAP)
    slot_start = np.concatenate([[0], np.cumsum(slots_per_cell)])[:-1]
    slot_of = slot_start[cid] + slot_in_cell
    cstart = np.nonzero(newc)[0]
    slot_win = np.repeat(win_o[cstart], slots_per_cell)
    slot_blk = np.repeat(blk_o[cstart], slots_per_cell)

    # pack slots 8 per slab within each window (slots arrive
    # (window, block)-sorted); pad window slab counts to s_batch
    srank = _rank_within(slot_win)
    raw_slab_in_win = srank // SUBS
    sub_of_slot = srank % SUBS
    wcnt = np.zeros(n_windows, np.int64)
    np.maximum.at(wcnt, slot_win, raw_slab_in_win + 1)
    slabs_per_win = np.maximum(1, wcnt)
    if s_batch is None:
        s_batch = pick_s_batch(wcnt)
    slabs_pad = -(-slabs_per_win // s_batch) * s_batch
    slab_start = np.concatenate([[0], np.cumsum(slabs_pad)])[:-1]
    nslabs = int(slabs_pad.sum())
    slab_of_slot = slab_start[slot_win] + raw_slab_in_win
    slab_of = slab_of_slot[slot_of]
    sub_of = sub_of_slot[slot_of]

    val_arr = np.zeros((nslabs, SUBS, LANES), cdt)
    vidx_arr = np.zeros((nslabs, SUBS, LANES), np.int16)
    val_arr[slab_of, sub_of, lane_of] = v.astype(cdt)
    vidx_arr[slab_of, sub_of, lane_of] = (c & (RW_ROWS - 1)).astype(
        np.int16)

    # x row of (slab, chunk cc, sublane) = block * 8 + cc
    xmap = np.zeros((nslabs, SPAN_ROWS), np.int32)
    cc = np.arange(XBLOCK_ROWS, dtype=np.int32)
    xmap[slab_of_slot, cc[:, None] * SUBS + sub_of_slot[None, :]] = (
        slot_blk[None, :] * XBLOCK_ROWS + cc[:, None]).astype(np.int32)

    planes, rounds = _runs_planes(slab_of, sub_of, lane_of, r, nslabs)
    win_arr = np.repeat(np.arange(n_windows), slabs_pad)
    return _finish_stream(val_arr, vidx_arr, planes, None, win_arr,
                          s_batch, rounds, span_rows=SPAN_ROWS,
                          stack=stack, xmap_arr=xmap)


def _build_dual(g_row, g_col, val, m, span_rows, stack,
                cdt=np.dtype(np.float32),
                s_batch: Optional[int] = None) -> Optional[StreamChunks]:
    """Dual-span slab packing: walk each window's (superspan) groups in
    span order; an open slab carries the previous group's leftover
    (span A) and takes min(count, free) of the next group per sublane
    (span B, vidx bit 13); remaining entries fill fresh mono slabs whose
    final partial stays open for the next group. Entries of both groups
    are merged row-sorted per (slab, sublane), so runs, the coloring,
    and every downstream stage are the mono machinery unchanged."""
    n_windows = max(1, -(-m // RW_ROWS))
    f64 = cdt == np.dtype(np.float64)
    from ...core import native
    raw = native.stream_plan(g_row, g_col, val, m, span_rows=span_rows,
                             dual=True, want_lo=f64, s_batch=s_batch)
    if raw is not None:
        win_full = np.repeat(raw["cw"], raw["s_batch"])
        return _finish_stream(raw["val"], raw["vidx"], raw["planes"],
                              raw["sbase"], win_full, raw["s_batch"],
                              raw["rounds"], span_rows=span_rows,
                              stack=stack, sbase2_arr=raw["sbase2"],
                              dual=True, val_lo_arr=raw.get("val_lo"))
    nz = g_row.shape[0]
    sh = 7 + int(span_rows).bit_length() - 1
    vmask = 16 * span_rows - 1
    win = (g_row >> 10).astype(np.int64)
    span = (g_col >> sh).astype(np.int64)
    sub = ((g_col >> (sh - 3)) & 7).astype(np.int64)
    order = np.lexsort((g_row, sub, span, win))
    r = g_row[order]
    c = g_col[order]
    v = val[order].astype(np.float64)
    win_o, span_o, sub_o = win[order], span[order], sub[order]

    gkey = win_o * (np.int64(1) << 34) + span_o
    newg = np.ones(nz, bool)
    newg[1:] = gkey[1:] != gkey[:-1]
    gid = np.cumsum(newg) - 1
    ngroups = int(gid[-1]) + 1
    gstart = np.nonzero(newg)[0]
    gwin = win_o[gstart]
    gspan = span_o[gstart]
    C = np.zeros((ngroups, SUBS), np.int64)
    np.add.at(C, (gid, sub_o), 1)

    # --- sequential greedy packing over group histograms ---
    take = np.zeros((ngroups, SUBS), np.int64)
    shared_slab = np.full(ngroups, -1, np.int64)
    base = np.zeros(ngroups, np.int64)
    sA, sB, swin = [], [], []            # per raw slab
    L = np.zeros(SUBS, np.int64)
    open_id = -1
    prev_w = -1
    for g in range(ngroups):
        w = int(gwin[g])
        if w != prev_w:
            open_id = -1
            L[:] = 0
            prev_w = w
        cv = C[g].copy()
        if open_id >= 0:
            t = np.minimum(cv, CAP - L)
            take[g] = t
            shared_slab[g] = open_id
            sB[open_id] = int(gspan[g]) * span_rows
            cv -= t
            open_id = -1
            L[:] = 0
        base[g] = len(sA)
        mx = int(cv.max())
        kf = max(0, -(-mx // CAP) - 1) if mx else 0
        leftover = np.clip(cv - kf * CAP, 0, None)
        nfresh = kf + (1 if leftover.any() else 0)
        pbase = int(gspan[g]) * span_rows
        for _ in range(nfresh):
            sA.append(pbase)
            sB.append(pbase)
            swin.append(w)
        open_id = len(sA) - 1 if leftover.any() else -1
        L = leftover
    if not sA:
        return None
    raw_win = np.asarray(swin, np.int64)
    sbaseA_raw = np.asarray(sA, np.int64)
    sbaseB_raw = np.asarray(sB, np.int64)

    # --- per-entry slab assignment ---
    rank = _rank_within(gid * SUBS + sub_o)
    tk = take[gid, sub_o]
    is_shared = rank < tk
    rr = rank - tk
    slab_of = np.where(is_shared, shared_slab[gid],
                       base[gid] + np.maximum(rr, 0) // CAP)

    # re-sort entries (slab, sublane, row) and assign lanes
    order2 = np.lexsort((r, sub_o, slab_of))
    slab_of = slab_of[order2]
    sub_o2 = sub_o[order2]
    r2 = r[order2]
    c2 = c[order2]
    v2 = v[order2]
    isB2 = is_shared[order2]
    lane_of = _rank_within(slab_of * SUBS + sub_o2) + 1
    if lane_of.max() > CAP:
        raise AssertionError("dual packing overflowed a sublane")

    # --- pad each window's slab count to a multiple of s_batch ---
    wcnt = np.bincount(raw_win, minlength=n_windows)
    slabs_per_win = np.maximum(1, wcnt)
    if s_batch is None:
        s_batch = pick_s_batch(wcnt)
    slabs_pad = -(-slabs_per_win // s_batch) * s_batch
    slab_start = np.concatenate([[0], np.cumsum(slabs_pad)])[:-1]
    nslabs = int(slabs_pad.sum())
    old2new = slab_start[raw_win] + _rank_within(raw_win)
    slab_of = old2new[slab_of]
    sbase = np.zeros(nslabs, np.int32)
    sbase2 = np.zeros(nslabs, np.int32)
    sbase[old2new] = sbaseA_raw.astype(np.int32)
    sbase2[old2new] = sbaseB_raw.astype(np.int32)

    val_arr = np.zeros((nslabs, SUBS, LANES), cdt)
    vidx_arr = np.zeros((nslabs, SUBS, LANES), np.int16)
    val_arr[slab_of, sub_o2, lane_of] = v2.astype(cdt)
    vidx_arr[slab_of, sub_o2, lane_of] = (
        (c2 & vmask) | (isB2.astype(np.int64) << 13)).astype(np.int16)
    planes, rounds = _runs_planes(slab_of, sub_o2, lane_of, r2, nslabs)
    win_arr = np.repeat(np.arange(n_windows), slabs_pad)
    return _finish_stream(val_arr, vidx_arr, planes, sbase, win_arr,
                          s_batch, rounds, span_rows=span_rows,
                          stack=stack, sbase2_arr=sbase2, dual=True)


def build_stream_classes(g_row: np.ndarray, g_col: np.ndarray,
                         val: np.ndarray, m: int,
                         span_rows: Optional[int] = None,
                         dual: Optional[bool] = None,
                         compute_dtype=np.float32):
    """Build the stream plan (values of `compute_dtype`, as
    build_stream_chunks) AND its two-rate (base, heavy) split in one
    pass. Returns (base, heavy | None); (None, None) for no entries.

    Fast path: the native builder runs once (slabs-per-step 1), Python
    decides the split on per-slab metadata only, and C++ exports each
    class directly in its final kernel layout. Falls back to
    build_stream_chunks + split_stream_chunks when the library is
    unavailable (bit-identical results). `span_rows` and `dual` as in
    build_stream_chunks."""
    if g_row.shape[0] == 0:
        return None, None
    cdt = np.dtype(compute_dtype)
    f64 = cdt == np.dtype(np.float64)
    fp = False
    if span_rows is None and dual is None:
        span_rows, dual, fp = pick_geometry_fp(g_row, g_col, m)
    elif span_rows is None:
        span_rows = pick_span_rows(g_row, g_col, m)
    dual = bool(dual)
    if fp:
        # free-placement class: NumPy builder + host split (the native
        # export emits aligned-span plans only)
        return split_stream_chunks(
            _build_fp(g_row, g_col, val, m, stack=False, cdt=cdt))
    from ...core import native
    out = native.stream_plan_classes(
        g_row, g_col, val, m, span_rows=span_rows, dual=dual,
        split_fn=pick_stream_split, want_lo=f64)
    if out is not None:
        classes = [with_entry_rows(StreamChunks(
            val=(cd["val"].astype(np.float64) + cd["val_lo"] if f64
                 else cd["val"]),
            vidx=cd["vidx"], planes=cd["planes"],
            sbase=cd["sbase"], cw=cd["cw"], cfirst=cd["cfirst"],
            sactive=cd["sactive"], sbase2=cd.get("sbase2"),
            s_batch=cd["s_batch"], rounds_=cd["rounds"],
            span_rows=span_rows, dual=dual)) for cd in out]
        return classes[0], classes[1] if len(classes) > 1 else None
    return split_stream_chunks(build_stream_chunks(
        g_row, g_col, val, m, span_rows=span_rows, dual=dual, stack=False,
        compute_dtype=cdt))


def _finish_stream(val_arr, vidx_arr, planes, sbase, win_arr, s_batch,
                   rounds, span_rows: int = SPAN_ROWS, stack: bool = True,
                   sbase2_arr=None, dual: bool = False,
                   xmap_arr=None, val_lo_arr=None) -> StreamChunks:
    """Order slabs by load within each window (so empty padding slabs
    cluster into trailing steps the kernel can skip), stack the round
    planes per step, and build the per-step control scalars. f32 values
    stay f32; f64 values become f64_plan_value after the load count (as
    the reference splits them after it), and a native pair (f32 hi in
    `val_arr`, `val_lo_arr`) becomes hi + lo. `stack` False keeps the
    planes in the RAW per-slab layout (an intermediate for
    split_stream_chunks)."""
    nslabs = val_arr.shape[0]
    load = np.count_nonzero(val_arr.reshape(nslabs, -1), axis=1)
    order = np.lexsort((-load, win_arr))
    val_arr = val_arr[order]
    vidx_arr = vidx_arr[order]
    planes = planes[order]
    if stack:
        planes = stack_step_planes(planes, s_batch, rounds)
    if xmap_arr is not None:
        # free placement: the span base is just slab * SPAN_ROWS
        xmap_arr = xmap_arr[order]
        sbase = np.arange(nslabs, dtype=np.int64) * SPAN_ROWS
    else:
        sbase = sbase[order]
    if sbase2_arr is not None:
        sbase2_arr = sbase2_arr[order]
    load = load[order]
    if val_lo_arr is not None:
        val_arr = (val_arr.astype(np.float64)
                   + val_lo_arr[order].astype(np.float64))
    elif val_arr.dtype == np.float64:
        val_arr = f64_plan_value(val_arr)

    win_step = win_arr[::s_batch]
    cw = win_step.astype(np.int32)
    cfirst = np.ones(cw.shape[0], np.int32)
    cfirst[1:] = (win_step[1:] != win_step[:-1]).astype(np.int32)
    sactive = (load.reshape(-1, s_batch).sum(axis=1) > 0).astype(np.int32)
    st = StreamChunks(
        val=val_arr, vidx=vidx_arr, planes=planes,
        sbase=sbase.astype(np.int32), cw=cw, cfirst=cfirst,
        sactive=sactive,
        sbase2=(sbase2_arr.astype(np.int32)
                if sbase2_arr is not None else None),
        xmap=(xmap_arr.reshape(-1).astype(np.int32)
              if xmap_arr is not None else None),
        s_batch=s_batch, rounds_=rounds, span_rows=span_rows, dual=dual)
    return with_entry_rows(st) if stack else st
