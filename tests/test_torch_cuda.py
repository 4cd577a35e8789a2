"""The CUDA class kernels (SpMV and SpMM) and the microbenchmark
kernels against their plain PyTorch versions on the card (the dense
SpMV and SpMM kernels also on a class with a one-lane chunk and a full
one, the band SpMV kernel at C = 1 and 3 and the band SpMM kernel at
C = 1, 3 and 7, the W-class SpMV and SpMM kernels at W = 16, 24 and 96
on edge-case tiles, each with a non-finite x, and the probe scripts' A/B
arms), the operator against the float64 golden, `profile_engines` and
`trace_context` on a CUDA operator, `from_plan` on a loaded plan file,
`.T` on a rectangular matrix, the bench harness's CUDA-graph time, and
the eight bf16-value kernels (`*_bf16`, f32 sums on f32 x and y) on
every class, at k = 2, 5 and 16, with Inf / NaN in x and on empty
classes, the bf16 operator against the golden within 2^-8; and the
multi-device layer (1-D in every x mode and dtype, 2-D, the timing and
the scaling sweep) on four virtual shards of the card, and over every
visible card where there are several.
Marked `cuda`: skipped where there is no GPU. Imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-5 * max(1, max|plain|) — the
order of float32 atomic adds varies from run to run; 1e-12 for the f64
kernels (float64 atomics), whose operator is held to the float64 golden
at max |y - golden| / (1 + |A|·|x|) <= 1e-12."""
import dataclasses

import numpy as np
import pytest
import torch

from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops.cuda import kernels, reference
from tilespmv_tpu_torch.ops.cuda import stream_plan as sp
from tilespmv_tpu_torch.scripts import (band_probes, dense_probes,
                                        microbench_gather,
                                        microbench_scatter, sparse_probes,
                                        spmm_probes)
from tilespmv_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

MATRICES = {
    "band": lambda: generate.get_matrix("banded_medium"),
    "dense_sparse_stream": lambda: generate.get_matrix("mixed_medium"),
    "stream_dual": lambda: generate.hypersparse(65536, 65536, 1e-4, seed=3),
    "stream_fp": lambda: generate.mixed_structure(512, 512, seed=1),
    "w96": lambda: generate.block_random(2048, 2048, density=0.05,
                                         fill=0.33, seed=5),
}
PAIRS = {"band": (kernels.band_spmv, reference.band_reference),
         "dense": (kernels.dense_spmv, reference.dense_reference),
         "sparse": (kernels.sparse_spmv, reference.sparse_rows_reference),
         "stream": (kernels.stream_spmv, reference.stream_rows_reference)}
MM_PAIRS = {
    "band": ("band_spmm", kernels.band_spmm, reference.band_spmm_reference),
    "dense": ("dense_spmm", kernels.dense_spmm,
              reference.dense_spmm_reference),
    "sparse": ("sparse_spmm", kernels.sparse_spmm,
               reference.sparse_rows_reference),
    "stream": ("stream2", kernels.stream_spmm,
               reference.stream_rows_reference)}


def _classes(plan):
    return {"band": [plan.band], "dense": [plan.dense],
            "sparse": list(plan.sparses),
            "stream": [plan.stream, plan.stream2]}


def _bench_x(n, k=None):
    """bench.py's dyadic x (column r shifted by r): exact f32 sums."""
    i = np.arange(n) if k is None else np.arange(n)[:, None] + np.arange(k)
    return ((i % 10) / 4.0).astype(np.float32)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernels_match_plain_versions(name, device):
    csr = MATRICES[name]()
    op = TileSpMV(csr, device=device)
    plan = op.device_plan()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, csr.n).astype(np.float32)).to(device)
    xp = reference.pad_x(plan, x)
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    ran = 0
    for kind, cls_list in _classes(plan).items():
        for cls in cls_list:
            if cls is None:
                continue
            wrap, plain = PAIRS[kind]
            yk = torch.zeros(ylen, device=device)
            yp = torch.zeros(ylen, device=device)
            before = kernels.launch_counts()[kind]
            wrap(cls, xp, yk)
            assert kernels.launch_counts()[kind] == before + 1
            plain(cls, xp, yp)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            assert err <= 1e-5 * max(1.0, float(yp.abs().max())), kind
            ran += 1
    assert ran
    # end to end vs the float64 golden with bench.py's x (cancellation
    # in a uniform(-1, 1) x would put f32 rounding above the bound)
    xb = _bench_x(csr.n)
    np.testing.assert_allclose(op(xb).cpu().numpy(),
                               csr.matvec(xb.astype(np.float64)),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("k", [2, 5, 8, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_kernels_match_plain_versions(name, k, device):
    """Each SpMM kernel once per class over all k columns (the stream
    kernel too: one stream2 launch, no SpMV stream launch) against its
    plain version; then the operator against the golden at k and 17."""
    csr = MATRICES[name]()
    op = TileSpMV(csr, device=device)
    plan = op.device_plan()
    x = torch.from_numpy(np.random.default_rng(k).uniform(
        -1, 1, (csr.n, k)).astype(np.float32)).to(device)
    xp = reference.pad_x(plan, x)
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    ran = 0
    for kind, cls_list in _classes(plan).items():
        key, wrap, plain = MM_PAIRS[kind]
        for cls in cls_list:
            if cls is None:
                continue
            yk = torch.zeros(ylen, k, device=device)
            yp = torch.zeros(ylen, k, device=device)
            before = kernels.launch_counts()
            wrap(cls, xp, yk)
            after = kernels.launch_counts()
            assert after[key] == before[key] + 1
            assert after["stream"] == before["stream"]
            plain(cls, xp, yp)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            assert err <= 1e-5 * max(1.0, float(yp.abs().max())), kind
            ran += 1
    assert ran
    # the operator end to end against the golden, fused and per column
    for kk in (k, 17):
        xb = _bench_x(csr.n, kk)
        got = (op @ xb).cpu().numpy()
        want = np.stack([csr.matvec(xb[:, r].astype(np.float64))
                         for r in range(kk)], axis=1)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


F64_MATRICES = {
    "band": lambda: generate.get_matrix("banded_medium"),
    "dense_t256_stream": lambda: generate.mixed_structure(4096, 4096,
                                                          seed=1),
    "dense_stream_fp": lambda: generate.mixed_structure(512, 512, seed=7),
    "stream": lambda: generate.power_law(4096, 4096, 12, seed=3),
    "mixed_medium": lambda: generate.get_matrix("mixed_medium"),
}


@pytest.mark.parametrize("name", sorted(F64_MATRICES))
def test_f64_kernels_match_plain_versions(name, device):
    csr = F64_MATRICES[name]()
    op = TileSpMV(csr, device=device, dtype=torch.float64)
    plan = op.device_plan()
    assert not plan.sparses
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, csr.n)).to(device)
    xp = reference.pad_x(plan, x)
    assert xp.dtype == torch.float64
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    ran = 0
    for kind in ("band", "dense", "stream"):
        for cls in _classes(plan)[kind]:
            if cls is None:
                continue
            wrap, plain = PAIRS[kind]
            yk = torch.zeros(ylen, dtype=torch.float64, device=device)
            yp = torch.zeros(ylen, dtype=torch.float64, device=device)
            before = kernels.launch_counts()
            wrap(cls, xp, yk)
            after = kernels.launch_counts()
            assert after[kind + "_f64"] == before[kind + "_f64"] + 1
            assert after[kind] == before[kind]
            plain(cls, xp, yp)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            assert err <= 1e-12 * max(1.0, float(yp.abs().max())), kind
            ran += 1
    assert ran
    # end to end against the float64 golden
    xs = x.cpu().numpy()
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    prod = csr.data * xs[csr.indices]
    gold = np.bincount(rows, weights=prod, minlength=csr.m)
    mag = np.bincount(rows, weights=np.abs(prod), minlength=csr.m)
    y = op(x)
    assert y.dtype == torch.float64
    assert np.max(np.abs(y.cpu().numpy() - gold) / (1 + mag)) <= 1e-12


def _entries(seed, m, n, nnz, heavy_rows=0):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, m, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    if heavy_rows:
        row[: nnz // 3] = rng.integers(0, heavy_rows, nnz // 3)
    _, ix = np.unique(row * n + col, return_index=True)
    return row[ix], col[ix], rng.standard_normal(ix.size), m, n


def _skewed(seed=7, n_windows=24):
    """Two heavy windows and many light ones: a split (base, heavy)
    pair."""
    rng = np.random.default_rng(seed)
    m = n = n_windows * 1024
    rows, cols = [], []
    for w in range(n_windows):
        k = 40000 if w < 2 else 8
        rows.append(rng.integers(w * 1024, (w + 1) * 1024, k))
        cols.append(rng.integers(0, n if w < 2 else 8192, k))
    key = np.unique(np.concatenate(rows).astype(np.int64) * n
                    + np.concatenate(cols))
    return key // n, key % n, rng.standard_normal(key.size), m, n


# stream classes straight from the builders: (entries, builder)
STREAM_CLASSES = {
    "mono": (lambda: _entries(1, 4096, 4096, 30000, heavy_rows=3),
             dict(span_rows=64, dual=False)),
    "dual": (lambda: _entries(11, 16384, 16384, 100_000),
             dict(span_rows=64, dual=True)),
    "xmap": (lambda: _entries(4, 65536, 65536, 4000), dict(fp=True)),
    "split_pair": (_skewed, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(STREAM_CLASSES))
def test_stream_kernel_matches_rows_reference(case, dtype, device):
    """stream.cu at every slabs-per-block group against
    stream_rows_reference: 1e-5 (f32) or 1e-12 (f64) of max(1, max|y|)."""
    make, kw = STREAM_CLASSES[case]
    row, col, val, m, n = make()
    cdt = np.float64 if dtype == torch.float64 else np.float32
    if kw is None:
        classes = sp.build_stream_classes(row, col, val, m, span_rows=64,
                                          dual=True, compute_dtype=cdt)
        assert classes[1] is not None
    else:
        classes = (sp.build_stream_chunks(row, col, val, m,
                                          compute_dtype=cdt, **kw),)
    assert (classes[0].xmap is not None) == (case == "xmap")
    x = np.random.default_rng(2).uniform(-1, 1, n)
    rows = -(-n // 128) + sp.MAX_SPAN_ROWS
    xp = torch.zeros(-(-rows // sp.SPAN_ROWS) * sp.SPAN_ROWS * 128,
                     dtype=dtype, device=device)
    xp[:n] = torch.from_numpy(x)
    ylen = max(1, -(-m // 1024)) * 1024
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for st in classes:
        st = dataclasses.replace(st, **{
            f.name: torch.as_tensor(getattr(st, f.name), device=device)
            for f in dataclasses.fields(st)
            if f.type == "Any" and getattr(st, f.name) is not None})
        yp = reference.stream_rows_reference(
            st, xp, torch.zeros(ylen, dtype=dtype, device=device))
        for group in (1, 2, 4, st.s_batch):
            yk = torch.zeros(ylen, dtype=dtype, device=device)
            kernels.stream_spmv(st, xp, yk, group=group)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            assert err <= tol * max(1.0, float(yp.abs().max())), (group,
                                                                   err)
        assert float(yp.abs().max()) > 0


def dense_edges_csr():
    """4096 x 4096, one output window, 257 dense 16x16 tiles: at (r, r)
    full and at (r, r + 100) with 6 + r % 11 scattered nonzero columns
    for tile-rows r < 128, and one full at (200, 5). Every tile-row
    spans more than 8 tile-columns or holds one tile, so there is no band
    class. The f32 dense class holds chunks of 256 active lanes and of 1
    (T = 256); the f64 one (unique-row rounds, T = 128) chunks of 128 and
    of 1."""
    rng = np.random.default_rng(3)
    r = np.arange(128)
    tr = np.concatenate([r, r, [200]])
    tc = np.concatenate([r, r + 100, [5]])
    i, j = (a.ravel() for a in np.meshgrid(np.arange(16), np.arange(16),
                                           indexing="ij"))
    keep = np.ones((tr.size, 256), bool)
    keep[128:256] = ((7 * j[None, :] + r[:, None]) % 16
                     < 6 + r[:, None] % 11)
    rows = (tr[:, None] * 16 + i)[keep]
    cols = (tc[:, None] * 16 + j)[keep]
    return generate.csr_from_coo(4096, 4096, rows, cols,
                                 rng.standard_normal(rows.size))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_kernel_one_lane_and_full_chunks(dtype, device):
    """dense.cu on a class with a one-lane chunk, a full chunk and tiles
    with zero columns: one launch, the plain versions (dense_reference
    and dense.cu's walk, dense_active_reference) within 1e-5 (f32) or
    1e-12 (f64) of max(1, max|plain|); then every A/B arm of
    scripts/dense_probes."""
    csr = dense_edges_csr()
    plan = TileSpMV(csr, device=device, dtype=dtype).device_plan()
    d = plan.dense
    nact = (d.meta[:, 0] >= 0).sum(dim=1).tolist()
    assert 1 in nact and d.t_lanes in nact and plan.band is None
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, csr.n)).to(device, dtype)
    xp = reference.pad_x(plan, x)
    ylen = reference.zero_y(plan, xp).shape[0]
    name = "dense" + ("_f64" if dtype == torch.float64 else "")
    before = kernels.launch_counts()[name]
    yk = kernels.dense_spmv(d, xp, torch.zeros(ylen, dtype=dtype,
                                               device=device))
    assert kernels.launch_counts()[name] == before + 1
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for plain in (reference.dense_reference,
                  reference.dense_active_reference):
        yp = plain(d, xp, torch.zeros(ylen, dtype=dtype, device=device))
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        assert err <= tol * max(1.0, float(yp.abs().max())), (plain, err)
    arms = dense_probes.run_arms(d, xp, ylen, rounds=1)
    assert list(arms) == list(dense_probes.ARMS)
    assert all(a["ms"] > 0 for a in arms.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_kernel_takes_zero_columns_times_nonfinite_x(dtype, device):
    """An Inf in x at column 1 of tile-column 100, a zero column of tile
    (0, 100): dense.cu skips that column's value loads but takes every
    product, so its NaN (0 * Inf) and Inf fall where dense_reference's
    do, and its finite entries agree within 1e-5 (f32) or 1e-12 (f64)
    of max(1, max|plain|)."""
    csr = dense_edges_csr()
    plan = TileSpMV(csr, device=device, dtype=dtype).device_plan()
    x = np.random.default_rng(4).uniform(-1, 1, csr.n)
    x[100 * 16 + 1] = np.inf
    xp = reference.pad_x(plan, torch.from_numpy(x).to(device, dtype))
    ylen = reference.zero_y(plan, xp).shape[0]
    yk = kernels.dense_spmv(plan.dense, xp, torch.zeros(
        ylen, dtype=dtype, device=device))
    yp = reference.dense_reference(plan.dense, xp, torch.zeros(
        ylen, dtype=dtype, device=device))
    torch.cuda.synchronize()
    assert bool(yp.isnan().any()) and bool(yp.isinf().any())
    assert torch.equal(yk.isnan(), yp.isnan())
    assert torch.equal(yk.isinf(), yp.isinf())
    fin = yp.isfinite()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    err = float((yk[fin] - yp[fin]).abs().max())
    assert err <= tol * max(1.0, float(yp[fin].abs().max()))


# band classes at their edges: C = 1 over three windows, the last holding
# 10 of its 256 tile rows; C = 3, with lanes whose column blocks cross
# into the next x panel (loc >> 8 moves on)
BAND_EDGES = {
    "band_c1": lambda: generate.banded(256 * 16 * 2 + 160,
                                       256 * 16 * 2 + 160, 2, seed=13),
    "band_c3": lambda: generate.get_matrix("banded_medium"),
}
# x columns set to Inf and NaN in the non-finite cases: inside the band
# of both BAND_EDGES matrices
INF_COL, NAN_COL = 5 * 16 + 3, 300 * 16 + 7


def check_band_edges(name, plan) -> None:
    """The edge BAND_EDGES[name]'s band class stands for, on its plan
    (tensors on any device)."""
    bd = plan.band
    assert bd is not None
    loc = bd.bloc.reshape(-1).long() & 255
    if name == "band_c1":
        assert bd.c_cols == 1 and bd.val.shape[0] == 3
        assert 0 < plan.tilem - 2 * 256 < 256
    else:
        assert bd.c_cols == 3
        assert bool((loc + bd.c_cols - 1 >= 256).any())


def sparse_edges_csr(width: int):
    """8192 x 8192, 600 tiles of one W-class (W = width in 16, 24, 96):
    two tiles on each of tile-rows 0..299, a third of them with W - 1
    entries and the others with 1..W-2 (above the next narrower class's
    W - 1), each with row 0, 7 or 15 empty. The last chunk holds 88
    tiles, so its fourth 32-lane group is inert."""
    rng = np.random.default_rng(width)
    lo = {16: 1, 24: 16, 96: 64}[width]
    rows, cols = [], []
    for i in range(600):
        tr = i // 2
        tc = (tr * 37 + (i % 2) * 211) % 512
        cnt = width - 1 if i % 3 == 0 else lo + i % (width - 1 - lo)
        empty = (0, 7, 15)[(i // 3) % 3]
        cells = np.flatnonzero(np.arange(256) // 16 != empty)
        pick = rng.choice(cells, cnt, replace=False)
        rows.append(tr * 16 + pick // 16)
        cols.append(tc * 16 + pick % 16)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return generate.csr_from_coo(8192, 8192, rows, cols,
                                 rng.standard_normal(rows.size))


SPARSE_EDGE_WIDTHS = (16, 24, 96)


def check_sparse_edges(width: int, plan):
    """sparse_edges_csr(width)'s plan (tensors on any device) has one
    W-class of that width, with a chunk holding an inert 32-lane group
    beside active lanes, tiles of W - 1 entries, and tiles whose row 0,
    row 7 or row 15 is empty; returns the class."""
    assert len(plan.sparses) == 1 and plan.dense is None
    s = plan.sparses[0]
    assert s.width == width
    act = (s.meta[:, 0] >= 0).cpu()
    inert = ~act.view(act.shape[0], -1, 32).any(dim=2)
    assert bool((inert.any(dim=1) & act.any(dim=1)).any())
    rend = reference._sparse_rend(s).cpu()
    prev = torch.cat([torch.zeros_like(rend[:, :1]), rend[:, :-1]], dim=1)
    assert bool((rend[:, 15][act] == width - 1).any())
    for r in (0, 7, 15):
        assert bool(((rend[:, r] == prev[:, r]) & act).any()), r
    return s


def _agree(yk, yp, tol) -> None:
    """NaN for NaN and Inf for Inf (sign included), the finite entries
    within tol * max(1, max|plain|)."""
    assert torch.equal(yk.isnan(), yp.isnan())
    assert torch.equal(yk.isinf() & (yk > 0), yp.isinf() & (yp > 0))
    assert torch.equal(yk.isinf() & (yk < 0), yp.isinf() & (yp < 0))
    fin = yp.isfinite()
    err = float((yk[fin] - yp[fin]).abs().max())
    assert err <= tol * max(1.0, float(yp[fin].abs().max())), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(BAND_EDGES))
def test_band_kernel_edges(name, dtype, device):
    """band.cu at C = 1 (a last window partly inside the matrix) and
    C = 3 (lanes crossing a panel): one launch, band_reference within
    1e-5 (f32) or 1e-12 (f64) of max(1, max|plain|); with an Inf and a
    NaN in x, NaN for NaN and Inf for Inf (every product is taken, zeros
    included); then every A/B arm of scripts/band_probes."""
    csr = BAND_EDGES[name]()
    plan = TileSpMV(csr, device=device, dtype=dtype).device_plan()
    check_band_edges(name, plan)
    kname = "band" + ("_f64" if dtype == torch.float64 else "")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    x = np.random.default_rng(6).uniform(-1, 1, csr.n)
    xb = x.copy()
    xb[INF_COL], xb[NAN_COL] = np.inf, np.nan
    for xh in (x, xb):
        xp = reference.pad_x(plan, torch.from_numpy(xh).to(device, dtype))
        ylen = reference.zero_y(plan, xp).shape[0]
        before = kernels.launch_counts()[kname]
        yk = kernels.band_spmv(plan.band, xp, torch.zeros(
            ylen, dtype=dtype, device=device))
        assert kernels.launch_counts()[kname] == before + 1
        yp = reference.band_reference(plan.band, xp, torch.zeros(
            ylen, dtype=dtype, device=device))
        torch.cuda.synchronize()
        assert bool(yp.isfinite().all()) == (xh is x)
        _agree(yk, yp, tol)
    xp = reference.pad_x(plan, torch.from_numpy(x).to(device, dtype))
    arms = band_probes.run_arms(plan.band, xp, ylen, rounds=1)
    assert list(arms) == list(band_probes.ARMS)
    assert all(a["ms"] > 0 for a in arms.values())


@pytest.mark.parametrize("width", SPARSE_EDGE_WIDTHS)
def test_sparse_kernel_edges(width, device):
    """sparse.cu on a class with an inert 32-lane group, tiles of W - 1
    entries and tiles with row 0, 7 or 15 empty: one launch,
    sparse_rows_reference and sparse_reference within 1e-5 of
    max(1, max|plain|); with an Inf in x at the column of a tile's first
    entry, NaN for NaN and Inf for Inf against sparse_rows_reference;
    then every A/B arm of scripts/sparse_probes."""
    csr = sparse_edges_csr(width)
    plan = TileSpMV(csr, device=device).device_plan()
    s = check_sparse_edges(width, plan)
    x = np.random.default_rng(7).uniform(-1, 1, csr.n).astype(np.float32)
    xb = x.copy()
    xb[reference.class_coo(s)[1][0]] = np.inf
    for xh in (x, xb):
        xp = reference.pad_x(plan, torch.from_numpy(xh).to(device))
        ylen = reference.zero_y(plan, xp).shape[0]
        before = kernels.launch_counts()["sparse"]
        yk = kernels.sparse_spmv(s, xp, torch.zeros(ylen, device=device))
        assert kernels.launch_counts()["sparse"] == before + 1
        plains = (reference.sparse_rows_reference,) + (
            (reference.sparse_reference,) if xh is x else ())
        for plain in plains:
            yp = plain(s, xp, torch.zeros(ylen, device=device))
            torch.cuda.synchronize()
            assert bool(yp.isinf().any()) == (xh is xb)
            _agree(yk, yp, 1e-5)
    xp = reference.pad_x(plan, torch.from_numpy(x).to(device))
    arms = sparse_probes.run_arms([s], xp, ylen, rounds=1)
    assert list(arms) == list(sparse_probes.ARMS)
    assert all(a["ms"] > 0 for a in arms.values())


@pytest.mark.parametrize("width", SPARSE_EDGE_WIDTHS)
def test_sparse_spmm_kernel_edges(width, device):
    """sparse_spmm.cu at k = 8 and 16 on test_sparse_kernel_edges'
    classes: one launch, sparse_rows_reference within 1e-5 of
    max(1, max|plain|); with +Inf and NaN in X column 3 (at the columns
    of two tiles' first entries), NaN for NaN and Inf for Inf against
    sparse_rows_reference, the other columns finite."""
    csr = sparse_edges_csr(width)
    plan = TileSpMV(csr, device=device).device_plan()
    s = check_sparse_edges(width, plan)
    cols = reference.class_coo(s)[1]
    for k in (8, 16):
        x = np.random.default_rng(k).uniform(-1, 1, (csr.n, k)).astype(
            np.float32)
        xb = x.copy()
        xb[cols[0], 3], xb[cols[-1], 3] = np.inf, np.nan
        for xh in (x, xb):
            xp = reference.pad_x(plan, torch.from_numpy(xh).to(device))
            ylen = reference.zero_y(plan, xp).shape[0]
            before = kernels.launch_counts()["sparse_spmm"]
            yk = kernels.sparse_spmm(s, xp, torch.zeros(ylen, k,
                                                        device=device))
            assert kernels.launch_counts()["sparse_spmm"] == before + 1
            yp = reference.sparse_rows_reference(
                s, xp, torch.zeros(ylen, k, device=device))
            torch.cuda.synchronize()
            fin = torch.ones(k, dtype=torch.bool)
            fin[3] = xh is x
            assert torch.equal(yp.isfinite().all(dim=0).cpu(), fin)
            assert bool(yp.isnan().any()) == bool(yp.isinf().any()) == (
                xh is xb)
            _agree(yk, yp, 1e-5)


# band classes of the SpMM card test: BAND_EDGES and C = 7 (the planner's
# BAND_MAX_COLS is 8), whose 7 column blocks of X at k = 16 would not fit
# a block's shared memory at once
BAND_SPMM_EDGES = {
    **BAND_EDGES,
    "band_c7": lambda: generate.banded(8192, 8192, 40, seed=13),
}


@pytest.mark.parametrize("name", sorted(BAND_SPMM_EDGES))
def test_band_spmm_kernel_edges(name, device):
    """band_spmm.cu at C = 1 and 3 (BAND_EDGES) and C = 7, at k = 5, 8 and
    16: one launch, band_spmm_reference within 1e-5 of max(1, max|plain|);
    with +Inf and NaN in X column 2 (INF_COL, NAN_COL), NaN for NaN and
    Inf for Inf (every product is taken, zeros included), the other
    columns finite."""
    csr = BAND_SPMM_EDGES[name]()
    plan = TileSpMV(csr, device=device).device_plan()
    if name in BAND_EDGES:
        check_band_edges(name, plan)
    else:
        assert plan.band is not None and plan.band.c_cols == 7
    for k in (5, 8, 16):
        x = np.random.default_rng(k).uniform(-1, 1, (csr.n, k)).astype(
            np.float32)
        xb = x.copy()
        xb[INF_COL, 2], xb[NAN_COL, 2] = np.inf, np.nan
        for xh in (x, xb):
            xp = reference.pad_x(plan, torch.from_numpy(xh).to(device))
            ylen = reference.zero_y(plan, xp).shape[0]
            before = kernels.launch_counts()["band_spmm"]
            yk = kernels.band_spmm(plan.band, xp,
                                   torch.zeros(ylen, k, device=device))
            assert kernels.launch_counts()["band_spmm"] == before + 1
            yp = reference.band_spmm_reference(
                plan.band, xp, torch.zeros(ylen, k, device=device))
            torch.cuda.synchronize()
            fin = torch.ones(k, dtype=torch.bool)
            fin[2] = xh is x
            assert torch.equal(yp.isfinite().all(dim=0).cpu(), fin)
            _agree(yk, yp, 1e-5)


def test_dense_spmm_kernel_edges(device):
    """dense_spmm.cu at k = 5, 8 and 16 on dense_edges_csr's class (a
    one-lane chunk, a full chunk, tiles with zero columns): one launch,
    both plain versions (dense_active_reference, dense_reference) within
    1e-5 of max(1, max|plain|); with +Inf in X column 1 at column 1 of
    tile-column 100, a zero column of tile (0, 100), NaN (0 * Inf) for
    NaN and Inf for Inf."""
    csr = dense_edges_csr()
    plan = TileSpMV(csr, device=device).device_plan()
    d = plan.dense
    nact = (d.meta[:, 0] >= 0).sum(dim=1).tolist()
    assert 1 in nact and d.t_lanes in nact and plan.band is None
    for k in (5, 8, 16):
        x = np.random.default_rng(k).uniform(-1, 1, (csr.n, k)).astype(
            np.float32)
        xb = x.copy()
        xb[100 * 16 + 1, 1] = np.inf
        for xh in (x, xb):
            xp = reference.pad_x(plan, torch.from_numpy(xh).to(device))
            ylen = reference.zero_y(plan, xp).shape[0]
            before = kernels.launch_counts()["dense_spmm"]
            yk = kernels.dense_spmm(d, xp, torch.zeros(ylen, k,
                                                       device=device))
            assert kernels.launch_counts()["dense_spmm"] == before + 1
            for plain in (reference.dense_active_reference,
                          reference.dense_reference):
                yp = plain(d, xp, torch.zeros(ylen, k, device=device))
                torch.cuda.synchronize()
                assert bool(yp.isnan().any()) == (xh is xb)
                assert bool(yp[:, 1].isinf().any()) == (xh is xb)
                _agree(yk, yp, 1e-5)


def test_spmm_probe_arms_match_plain_versions(device):
    """Every arm of scripts/spmm_probes at k = 8 on mixed_medium's stream
    classes, W-classes and dense class and banded_medium's band class:
    each held to its plain version within 1e-5 of max(1, max|plain|)
    (inside ab_arms), then timed."""
    x = {}
    for name in ("mixed_medium", "banded_medium"):
        csr = generate.get_matrix(name)
        plan = TileSpMV(csr, device=device).device_plan()
        xp = reference.pad_x(plan, torch.from_numpy(
            np.random.default_rng(8).uniform(-1, 1, (csr.n, 8)).astype(
                np.float32)).to(device))
        x[name] = plan, xp, reference.zero_y(plan, xp).shape[0]
    plan = x["mixed_medium"][0]
    streams = [st for st in (plan.stream, plan.stream2) if st is not None]
    assert streams and plan.sparses and plan.dense is not None
    assert x["banded_medium"][0].band is not None
    for name, run, classes, arms in (
            ("mixed_medium", spmm_probes.run_stream, streams,
             spmm_probes.STREAM_ARMS),
            ("mixed_medium", spmm_probes.run_sparse, list(plan.sparses),
             spmm_probes.SPARSE_ARMS),
            ("mixed_medium", spmm_probes.run_dense, [plan.dense],
             spmm_probes.DENSE_ARMS),
            ("banded_medium", spmm_probes.run_band,
             [x["banded_medium"][0].band], spmm_probes.BAND_ARMS)):
        _, xp, ylen = x[name]
        res = run(classes, xp, ylen, rounds=1)
        assert list(res) == list(arms)
        assert all(r["ms"] > 0 for r in res.values())
        assert [a for a, r in res.items() if r["err"] is None] == [
            a for a in arms if a in spmm_probes.STREAM_TIMED_ONLY]


def _mb_check(name, variant, run, plain) -> None:
    """One launch of a microbenchmark kernel at each of 1, G - 1, G + 1
    and 300 steps (G: the units of its persistent grid; 1 leaves most
    units idle, G - 1 and G + 1 give some units a step more) against its
    plain version, within 1e-5 * max(1, max|plain|)."""
    units, cluster = kernels.microbench_grid(name, variant)
    assert units >= 1 and cluster in (1, 2)
    for n in sorted({1, max(1, units - 1), units + 1, 300}):
        before = kernels.launch_counts()[name]
        out = run(n)
        assert kernels.launch_counts()[name] == before + 1
        torch.cuda.synchronize()
        assert out.shape == (8, 128) and out.dtype == torch.float32
        err = float((out - plain).abs().max())
        assert err <= 1e-5 * max(1.0, float(plain.abs().max())), (n, err)


@pytest.mark.parametrize("r", reference.MB_GATHER_R)
def test_microbench_gather_matches_plain_version(r, device):
    src, idx = microbench_gather.inputs(seed=r, device=device)
    plain = reference.microbench_gather_reference(src, idx, r)
    _mb_check("microbench_gather", r,
              lambda n: kernels.microbench_gather(src, idx, r, nsteps=n),
              plain)
    assert kernels.microbench_grid("microbench_gather", r)[1] == 2


@pytest.mark.parametrize("arm", reference.MB_SCATTER_ARMS)
def test_microbench_scatter_matches_plain_version(arm, device):
    csum, pe = microbench_scatter.inputs(arm, seed=1, device=device)
    plain = reference.microbench_scatter_reference(arm, csum, pe)
    _mb_check("microbench_scatter", arm,
              lambda n: kernels.microbench_scatter(arm, csum, pe,
                                                   nsteps=n),
              plain)
    assert kernels.microbench_grid("microbench_scatter", arm)[1] == (
        2 if arm == "rounds" else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_profile_engines_on_cuda(dtype, device):
    op = TileSpMV(generate.get_matrix("mixed_medium"), device=device,
                  dtype=dtype)
    plan = op.device_plan()
    want = (["dense"] * (plan.dense is not None)
            + ["band"] * (plan.band is not None)
            + [f"sparse_w{s.width}" for s in plan.sparses]
            + [k for k, st in (("stream", plan.stream),
                               ("stream2", plan.stream2)) if st is not None]
            + ["residual"] * bool(plan.residual.val.shape[0]))
    before = kernels.launch_counts()
    prof = profiling.profile_engines(op)
    after = kernels.launch_counts()
    assert list(prof) == want
    assert all(v["us"] > 0 and v["bytes"] > 0 for v in prof.values())
    suffix = "_f64" if dtype == torch.float64 else ""
    assert after["stream" + suffix] > before["stream" + suffix]


def test_trace_context_traces_the_kernels(tmp_path, device):
    op = TileSpMV(generate.get_matrix("mixed_medium"), device=device)
    x = torch.from_numpy(_bench_x(op.shape[1])).to(device)
    op(x)
    with profiling.trace_context(tmp_path) as prof:
        op(x)
    assert len(list(tmp_path.glob("*.json"))) == 1
    dev_us = [e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev_us and sum(dev_us) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_from_plan_on_a_loaded_plan(dtype, tmp_path, device):
    from tilespmv_tpu_torch.core.serialize import (load_lane_plan,
                                                   save_lane_plan)
    csr = generate.get_matrix("mixed_medium")
    op = TileSpMV(csr, device=device, dtype=dtype)
    p = str(tmp_path / "plan.npz")
    save_lane_plan(p, op.device_plan())
    op2 = TileSpMV.from_plan(load_lane_plan(p), device=device, dtype=dtype)
    assert op2.device.type == "cuda" and op2.shape == op.shape
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, csr.n)).to(device)
    y, y2 = op(x), op2(x)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - y2).abs().max()) <= tol * max(1.0,
                                                    float(y.abs().max()))


def test_transpose_on_a_rectangular_archetype(device):
    from tilespmv_tpu_torch.utils.host import csr_transpose
    csr = generate.rectangular(16384, 1024, 8, seed=23)
    op = TileSpMV(csr, device=device)
    assert op.T.T is op and op.T.device.type == "cuda"
    y = _bench_x(csr.m)
    want = csr_transpose(csr).matvec(y.astype(np.float64))
    for got in (op.T(y), op.rmatvec(y)):
        assert got.shape == (csr.n,)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-4,
                                   atol=1e-4)


def test_benchmark_op_graph_time_within_eager_time(device):
    from tilespmv_tpu_torch.bench import harness, roofline
    op = TileSpMV(generate.get_matrix("mixed_medium"), device=device)
    x = torch.from_numpy(_bench_x(op.shape[1])).to(device)
    before = kernels.launch_counts()["dense"]
    op(x)
    per_call = kernels.launch_counts()["dense"] - before
    assert per_call
    before += per_call
    res = harness.benchmark_op(op, name="mixed_medium", warmup=2,
                               timed_reps=5, iters_per_rep=20)
    assert res.chip == roofline.detect_chip() and res.backend == "pallas"
    assert np.isfinite(res.ms) and 0 < res.ms <= res.eager_ms
    assert res.gflops == pytest.approx(2 * op.nnz / res.ms / 1e6)
    # a launch is counted where a call is issued: the warm-up call, the
    # 20 captured ones and the eager ones (2 warm-up, 5 timed rounds of
    # 20), none per replay of the graph
    assert kernels.launch_counts()["dense"] - before == \
        per_call * (1 + 20 * (1 + 2 + 5))


# bf16: the eight *_bf16 kernels read bf16 values and compute in f32 on
# f32 x and y; each is held to its plain version on that f32 y
BF16 = torch.bfloat16


def _bf16_x(n, k=None, seed=0):
    """A seeded uniform(-1, 1) x (n,) or (n, k), rounded to bf16 (the
    operator's cast) and widened back to float32 (the kernels' x)."""
    shape = (n,) if k is None else (n, k)
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape)).to(BF16).float()


def _bf16_run(wrap, key, cls, xp, y) -> torch.Tensor:
    """One launch of a bf16 kernel through its wrapper into y: its
    `<key>_bf16` count moves by one and the f32 kernel's not at all."""
    before = kernels.launch_counts()
    assert wrap(cls, xp, y) is y
    after = kernels.launch_counts()
    assert after[key + "_bf16"] == before[key + "_bf16"] + 1
    assert after[key] == before[key]
    return y


def _bf16_gate(y: torch.Tensor, gold: np.ndarray) -> None:
    """|y - golden| <= 2^-8 |golden| + 1e-6: with the generator's values
    (quarters) and a dyadic x every f32 sum is exact, and only y's one
    rounding to bf16 remains."""
    assert y.dtype == BF16
    err = np.abs(y.float().cpu().numpy() - gold)
    assert bool(np.all(err <= 2.0 ** -8 * np.abs(gold) + 1e-6)), err.max()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bf16_kernels_match_plain_versions(name, device):
    """Every class of the bf16 plan through its bf16 SpMV kernel and, at
    k = 2, 5 and 16, its bf16 SpMM kernel (one launch per class over all
    k columns) against the plain version on the f32 y, within 1e-5 of
    max(1, max|plain|); then the operator against the float64 golden
    with bench.py's x and matmat at k = 8 (_bf16_gate)."""
    csr = MATRICES[name]()
    op = TileSpMV(csr, device=device, dtype=BF16)
    plan = op.device_plan()
    assert plan.dtype == BF16
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    ran = 0
    for k in (None, 2, 5, 16):
        xp = reference.pad_x(plan, _bf16_x(csr.n, k, seed=k or 0).to(
            device))
        assert xp.dtype == torch.float32
        rhs = () if k is None else (k,)
        for kind, cls_list in _classes(plan).items():
            key, wrap, plain = ((kind, *PAIRS[kind]) if k is None
                                else MM_PAIRS[kind])
            for cls in cls_list:
                if cls is None:
                    continue
                assert cls.val.dtype == BF16
                yk = _bf16_run(wrap, key, cls, xp,
                               torch.zeros((ylen,) + rhs, device=device))
                yp = plain(cls, xp, torch.zeros((ylen,) + rhs,
                                                device=device))
                torch.cuda.synchronize()
                err = float((yk - yp).abs().max())
                assert err <= 1e-5 * max(1.0, float(yp.abs().max())), (
                    kind, k, err)
                ran += 1
    assert ran
    xb = _bench_x(csr.n)
    _bf16_gate(op(xb), csr.matvec(xb.astype(np.float64)))
    xb = _bench_x(csr.n, 8)
    got = op.matmat(xb)
    for r in range(8):
        _bf16_gate(got[:, r], csr.matvec(xb[:, r].astype(np.float64)))


def test_bf16_dense_kernel_edges(device):
    """dense.cu and dense_spmm.cu (k = 2, 5, 16) in bf16 on
    dense_edges_csr's class (a one-lane chunk, a full chunk, zero
    columns): both plain versions within 1e-5 of max(1, max|plain|);
    with an Inf in x at a zero column of a tile, NaN for NaN and Inf for
    Inf."""
    csr = dense_edges_csr()
    plan = TileSpMV(csr, device=device, dtype=BF16).device_plan()
    d = plan.dense
    nact = (d.meta[:, 0] >= 0).sum(dim=1).tolist()
    assert 1 in nact and d.t_lanes in nact and d.val.dtype == BF16
    for k in (None, 2, 5, 16):
        x = _bf16_x(csr.n, k, seed=4)
        xb = x.clone()
        xb[100 * 16 + 1] = np.inf
        for xh in (x, xb):
            xp = reference.pad_x(plan, xh.to(device))
            rhs = (reference.zero_y(plan, xp).shape[0],) + (
                () if k is None else (k,))
            key, wrap = ("dense", kernels.dense_spmv) if k is None else (
                "dense_spmm", kernels.dense_spmm)
            yk = _bf16_run(wrap, key, d, xp, torch.zeros(rhs,
                                                         device=device))
            for plain in (reference.dense_reference,
                          reference.dense_active_reference):
                yp = plain(d, xp, torch.zeros(rhs, device=device))
                torch.cuda.synchronize()
                assert bool(yp.isnan().any()) == (xh is xb)
                _agree(yk, yp, 1e-5)


@pytest.mark.parametrize("name", sorted(BAND_SPMM_EDGES))
def test_bf16_band_kernel_edges(name, device):
    """band.cu and band_spmm.cu (k = 2, 5, 16) in bf16 at C = 1, 3 and 7:
    band_reference within 1e-5 of max(1, max|plain|); with an Inf and a
    NaN in x (in column 1 of X), NaN for NaN and Inf for Inf."""
    csr = BAND_SPMM_EDGES[name]()
    plan = TileSpMV(csr, device=device, dtype=BF16).device_plan()
    if name in BAND_EDGES:
        check_band_edges(name, plan)
    assert plan.band.val.dtype == BF16
    for k in (None, 2, 5, 16):
        x = _bf16_x(csr.n, k, seed=6)
        xb = x.clone()
        if k is None:
            xb[INF_COL], xb[NAN_COL] = np.inf, np.nan
        else:
            xb[INF_COL, 1], xb[NAN_COL, 1] = np.inf, np.nan
        for xh in (x, xb):
            xp = reference.pad_x(plan, xh.to(device))
            rhs = (reference.zero_y(plan, xp).shape[0],) + (
                () if k is None else (k,))
            key, wrap = ("band", kernels.band_spmv) if k is None else (
                "band_spmm", kernels.band_spmm)
            yk = _bf16_run(wrap, key, plan.band, xp,
                           torch.zeros(rhs, device=device))
            yp = reference.band_reference(plan.band, xp,
                                          torch.zeros(rhs, device=device))
            torch.cuda.synchronize()
            assert bool(yp.isfinite().all()) == (xh is x)
            _agree(yk, yp, 1e-5)


@pytest.mark.parametrize("width", SPARSE_EDGE_WIDTHS)
def test_bf16_sparse_kernel_edges(width, device):
    """sparse.cu and sparse_spmm.cu (k = 2, 5, 16) in bf16 on
    sparse_edges_csr's class (an inert 32-lane group, tiles of W - 1
    entries, empty rows 0, 7 and 15): sparse_rows_reference within 1e-5
    of max(1, max|plain|); with an Inf in x (column 1 of X) at a tile's
    first entry and a NaN at another's, NaN for NaN and Inf for Inf."""
    csr = sparse_edges_csr(width)
    plan = TileSpMV(csr, device=device, dtype=BF16).device_plan()
    s = check_sparse_edges(width, plan)
    assert s.val.dtype == BF16
    cols = reference.class_coo(s)[1]
    for k in (None, 2, 5, 16):
        x = _bf16_x(csr.n, k, seed=7)
        xb = x.clone()
        c = () if k is None else (1,)
        xb[(cols[0],) + c], xb[(cols[-1],) + c] = np.inf, np.nan
        for xh in (x, xb):
            xp = reference.pad_x(plan, xh.to(device))
            rhs = (reference.zero_y(plan, xp).shape[0],) + (
                () if k is None else (k,))
            key, wrap = ("sparse", kernels.sparse_spmv) if k is None else (
                "sparse_spmm", kernels.sparse_spmm)
            yk = _bf16_run(wrap, key, s, xp, torch.zeros(rhs,
                                                         device=device))
            yp = reference.sparse_rows_reference(
                s, xp, torch.zeros(rhs, device=device))
            torch.cuda.synchronize()
            assert bool(yp.isnan().any()) == (xh is xb)
            _agree(yk, yp, 1e-5)


@pytest.mark.parametrize("case", sorted(STREAM_CLASSES))
def test_bf16_stream_kernels_match_rows_reference(case, device):
    """stream.cu (every slabs-per-block group) and stream2.cu (k = 2, 5,
    16) in bf16 on classes straight from the builders (mono, dual, free
    placement, a split pair) against stream_rows_reference, within 1e-5
    of max(1, max|plain|); with an Inf in x (column 1 of X) at an
    entry's column, NaN for NaN and Inf for Inf."""
    make, kw = STREAM_CLASSES[case]
    row, col, val, m, n = make()
    if kw is None:
        classes = tuple(map(sp.bf16_values, sp.build_stream_classes(
            row, col, val, m, span_rows=64, dual=True)))
        assert classes[1] is not None
    else:
        classes = (sp.bf16_values(
            sp.build_stream_chunks(row, col, val, m, **kw)),)
    rows = -(-n // 128) + sp.MAX_SPAN_ROWS
    xlen = -(-rows // sp.SPAN_ROWS) * sp.SPAN_ROWS * 128
    ylen = max(1, -(-m // 1024)) * 1024
    for st in classes:
        st = dataclasses.replace(st, **{
            f.name: reference.plan_tensor(getattr(st, f.name)).to(device)
            for f in dataclasses.fields(st)
            if f.type == "Any" and getattr(st, f.name) is not None})
        assert st.val.dtype == BF16
        for k in (None, 2, 5, 16):
            rhs = () if k is None else (k,)
            x = torch.zeros((xlen,) + rhs)
            x[:n] = _bf16_x(n, k, seed=2)
            xb = x.clone()
            xb[col[0]] = np.inf
            for xh in (x, xb):
                xp = xh.to(device)
                yp = reference.stream_rows_reference(
                    st, xp, torch.zeros((ylen,) + rhs, device=device))
                if k is None:
                    for group in (1, 2, 4, st.s_batch):
                        yk = torch.zeros(ylen, device=device)
                        kernels.stream_spmv(st, xp, yk, group=group)
                        torch.cuda.synchronize()
                        _agree(yk, yp, 1e-5)
                    _bf16_run(kernels.stream_spmv, "stream", st, xp,
                              torch.zeros(ylen, device=device))
                else:
                    yk = _bf16_run(kernels.stream_spmm, "stream2", st, xp,
                                   torch.zeros((ylen, k), device=device))
                    torch.cuda.synchronize()
                    _agree(yk, yp, 1e-5)
            assert float(yp.abs().max()) > 0


def _empty(cls):
    """`cls` (tensors) cut to no chunk, slab or step: a launch with
    nothing to do."""
    if isinstance(cls, sp.StreamChunks):
        kw = {f: getattr(cls, f)[:0] for f in (
            "val", "vidx", "erow", "planes", "sbase", "cw", "cfirst",
            "sactive") + (("sbase2",) if cls.sbase2 is not None else ())}
        if cls.xmap is not None:
            kw["xmap"] = cls.xmap[:0]
        return dataclasses.replace(cls, **kw)
    kw = {f.name: getattr(cls, f.name)[:0] for f in dataclasses.fields(cls)
          if isinstance(getattr(cls, f.name), torch.Tensor)}
    return dataclasses.replace(cls, **kw)


def test_bf16_kernels_on_empty_classes(device):
    """Each of the eight bf16 kernels launched on a class with no chunk,
    slab or step (grid 0: no kernel runs, the launch is still checked and
    counted) leaves y zero."""
    plan = TileSpMV(generate.get_matrix("mixed_medium"), device=device,
                    dtype=BF16).device_plan()
    band = TileSpMV(generate.get_matrix("banded_medium"), device=device,
                    dtype=BF16).device_plan().band
    xp = reference.pad_x(plan, _bf16_x(plan.n).to(device))
    xk = reference.pad_x(plan, _bf16_x(plan.n, 5).to(device))
    ylen = reference.zero_y(plan, xp).shape[0]
    for kind, cls in (("band", band), ("dense", plan.dense),
                      ("sparse", plan.sparses[0]), ("stream", plan.stream)):
        cls = _empty(cls)
        y = _bf16_run(PAIRS[kind][0], kind, cls, xp,
                      torch.zeros(ylen, device=device))
        key, wrap, _ = MM_PAIRS[kind]
        y5 = _bf16_run(wrap, key, cls, xk, torch.zeros(ylen, 5,
                                                       device=device))
        torch.cuda.synchronize()
        assert not bool(y.any()) and not bool(y5.any())


# the xla engines (plain torch ops) and the forced lane plans

XLA_DTYPES = (torch.float32, torch.float64, BF16)


def _magnitude(csr, x: np.ndarray) -> np.ndarray:
    """|A|·|x| per row (x (n,) or (n, k)), in float64."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    x = np.abs(x.astype(np.float64))
    out = np.zeros((csr.m,) + x.shape[1:])
    np.add.at(out, rows, np.abs(csr.data)[:, None] * x[csr.indices]
              if x.ndim == 2 else np.abs(csr.data) * x[csr.indices])
    return out


@pytest.mark.parametrize("dtype", XLA_DTYPES)
@pytest.mark.parametrize("b", [4, 8, 12, 16])
def test_xla_engines_on_the_card(b, dtype, device):
    """The xla backend on the card against the same plan on the CPU (the
    same torch engines): no class kernel launches; f32 within 1e-5 *
    max(1, max|y|), f64 within 1e-12 * (1 + |A|·|x|); bf16, whose
    engines sum in bf16 (as the reference's do), each device rounding in
    its own order: both y against the float64 golden on the bf16 x
    within 2^-6 * (|A|·|x|) + 1e-6 (tests/test_torch_bf16_slice.py's
    bound); y and matmat at k = 3; then the bench harness captures the
    xla path in a CUDA graph."""
    from tilespmv_tpu_torch import TileConfig
    from tilespmv_tpu_torch.bench import harness
    csr = generate.mixed_structure(2048, 2048, seed=3)
    cfg = TileConfig(tile_size=b)
    op = TileSpMV(csr, device=device, dtype=dtype, config=cfg,
                  backend="xla")
    cpu = TileSpMV(csr, device="cpu", dtype=dtype, config=cfg,
                   backend="xla")
    assert op.backend == "xla" and op.device.type == "cuda"
    for k in (None, 3):
        x = np.random.default_rng(k or 0).uniform(
            -1, 1, (csr.n,) if k is None else (csr.n, k))
        xt = torch.from_numpy(x).to(dtype)
        before = kernels.launch_counts()
        got = (op(xt.to(device)) if k is None
               else op.matmat(xt.to(device)))
        torch.cuda.synchronize()
        assert kernels.launch_counts() == before
        assert got.device.type == "cuda" and got.dtype == dtype
        want = (cpu(xt) if k is None else cpu.matmat(xt)).double().numpy()
        got = got.double().cpu().numpy()
        err = np.abs(got - want)
        mag = _magnitude(csr, xt.double().numpy())
        if dtype == torch.float32:
            assert err.max() <= 1e-5 * max(1.0, np.abs(want).max())
        elif dtype == torch.float64:
            assert (err / (1 + mag)).max() <= 1e-12
        else:
            x16 = xt.double().numpy()
            gold = csr.to_dense() @ x16
            for y in (got, want):
                assert np.all(np.abs(y - gold) <= 2.0 ** -6 * mag + 1e-6)
    res = harness.benchmark_op(op, name="mixed", warmup=1, timed_reps=3,
                               iters_per_rep=5)
    assert res.backend == "xla" and 0 < res.ms <= res.eager_ms


DISTRIBUTED = dict(force_t=128, use_stream=True, stream_s_batch=8,
                   stream_span_rows=64)
# matrices and the planner options that force their plans into shapes
# the automatic picks do not take
FORCED = {
    "mixed_distributed": (lambda: generate.mixed_structure(
        512, 512, seed=1), DISTRIBUTED),
    "medium_distributed": (lambda: generate.get_matrix("mixed_medium"),
                           DISTRIBUTED),
    "powerlaw_distributed": (lambda: generate.power_law(
        4096, 4096, 12, seed=3), DISTRIBUTED),
    "band_distributed": (lambda: generate.get_matrix("banded_medium"),
                         DISTRIBUTED),
    "mixed_s_batch": (lambda: generate.mixed_structure(512, 512, seed=1),
                      dict(stream_s_batch=8)),
    "empty_stream": (lambda: generate.dense_blocks(
        512, 512, num_blocks=96, seed=6), dict(use_stream=True)),
}
_SFX = {torch.float32: "", torch.float64: "_f64", BF16: "_bf16"}


def _forced_op(name, dtype, device):
    from tilespmv_tpu_torch.core.convert import tile_create
    from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan
    mk, opts = FORCED[name]
    csr = mk()
    plan = build_lane_plan(tile_create(csr), compute_dtype=str(dtype)
                           .removeprefix("torch."), **opts)
    return csr, TileSpMV.from_plan(plan, device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", XLA_DTYPES)
@pytest.mark.parametrize("name", sorted(FORCED))
def test_forced_plan_kernels_match_plain_versions(name, dtype, device):
    """Every class of a forced plan (T = 128 with c_batch 1 and K 4; one
    stream class at S = 8, span 64, mono; free placement at S = 8; the
    all-inert class) through its kernel against its plain version
    (1e-5 * max(1, max|plain|), f64 1e-12), the SpMM kernels at k = 8 on
    f32 and bf16 plans; with the counters reset, op(x) launches every
    class kernel the plan holds, and y passes the golden (f32 rtol 2e-4
    / atol 1e-4, f64 1e-12 * (1 + |A|·|x|), bf16 _bf16_gate)."""
    csr, op = _forced_op(name, dtype, device)
    plan = op.device_plan()
    if "force_t" in FORCED[name][1] and plan.dense is not None:
        assert (plan.dense.t_lanes, plan.dense.c_batch,
                plan.dense.k_panels) == (128, 1, 4)
    if "stream_s_batch" in FORCED[name][1]:
        assert plan.stream.s_batch == 8 and plan.stream2 is None
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    want = set()
    for k in ((None,) if dtype == torch.float64 else (None, 8)):
        x = torch.from_numpy(np.random.default_rng(k or 0).uniform(
            -1, 1, (csr.n,) if k is None else (csr.n, k))).to(dtype)
        xp = reference.pad_x(plan, x.to(xdt).to(device))
        rhs = () if k is None else (k,)
        for kind, cls_list in _classes(plan).items():
            key, wrap, plain = ((kind, *PAIRS[kind]) if k is None
                                else MM_PAIRS[kind])
            for cls in cls_list:
                if cls is None:
                    continue
                name_k = key + _SFX[dtype]
                if k is None:
                    want.add(name_k)
                before = kernels.launch_counts()[name_k]
                yk = wrap(cls, xp, torch.zeros((ylen,) + rhs, dtype=xdt,
                                               device=device))
                assert kernels.launch_counts()[name_k] == before + 1
                yp = plain(cls, xp, torch.zeros((ylen,) + rhs, dtype=xdt,
                                                device=device))
                torch.cuda.synchronize()
                err = float((yk - yp).abs().max())
                assert err <= tol * max(1.0, float(yp.abs().max())), (
                    kind, k, err)
    assert want
    kernels.reset_launch_counts()
    xb = _bench_x(csr.n).astype(np.float64)
    y = op(xb)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(counts[k] for k in want), (want, counts)
    gold = csr.matvec(xb)
    if dtype == BF16:
        _bf16_gate(y, gold)
    elif dtype == torch.float64:
        mag = _magnitude(csr, xb)
        assert (np.abs(y.cpu().numpy() - gold) / (1 + mag)).max() <= 1e-12
    else:
        np.testing.assert_allclose(y.cpu().numpy(), gold, rtol=2e-4,
                                   atol=1e-4)


def test_spmm_k16_hub_rows_against_float64(device):
    """matmat at k = 16 on powerlaw_large (hub rows): the fused SpMM
    kernels and their plain version (`index_add_` on the card), each
    against a float64 product, not against each other. Each must lie
    within the float32 summation bound of its row, 2^-24 * (entries of
    the row + 1) * (|A|·|X|) per element; the kernels also within
    1e-5 * max(1, max|golden|)."""
    csr = generate.get_matrix("powerlaw_large")
    op = TileSpMV(csr, device=device)
    X = np.random.default_rng(16).uniform(-1, 1, (csr.n, 16)).astype(
        np.float32)
    xt = torch.from_numpy(X).to(device)
    yk = op.matmat(xt)
    yp = reference.spmm_reference(op.device_plan(), xt)
    rows = torch.from_numpy(np.repeat(np.arange(csr.m), np.diff(
        csr.indptr))).to(device)
    cols = torch.from_numpy(csr.indices.astype(np.int64)).to(device)
    vals = torch.from_numpy(csr.data).to(device, torch.float64)
    x64 = xt.double()
    gold = torch.zeros((csr.m, 16), dtype=torch.float64, device=device)
    gold.index_add_(0, rows, vals[:, None] * x64[cols])
    mag = torch.zeros_like(gold).index_add_(
        0, rows, vals.abs()[:, None] * x64[cols].abs())
    per_row = torch.from_numpy(np.diff(csr.indptr) + 1.0).to(device)
    bound = 2.0 ** -24 * per_row[:, None] * mag
    errs = []
    for y in (yk, yp):
        err = (y.double() - gold).abs()
        assert bool((err <= bound).all()), float((err - bound).max())
        errs.append(float(err.max()))
    print(f"k 16 powerlaw_large: max |Y - float64| kernels {errs[0]:.3e}, "
          f"plain {errs[1]:.3e}, max |float64| "
          f"{float(gold.abs().max()):.3e}")
    assert errs[0] <= 1e-5 * max(1.0, float(gold.abs().max()))


# the multi-device layer on four virtual shards of the card
VIRTUAL4 = ["cuda:0"] * 4
DIST_CASES = [("mixed_medium", m, dt) for m in ("allgather", "replicated",
                                                 "halo")
              for dt in XLA_DTYPES] + [("banded_medium", "halo",
                                        torch.float32),
                                       ("banded_medium", "auto",
                                        torch.float32)]


def _dist_close(got: torch.Tensor, want: torch.Tensor, csr, x, dtype):
    """Card y against the same operator's y from the plain versions on
    a CPU mesh: f32 1e-5 * max(1, max|want|) (atomics add in any order),
    f64 1e-12 * (1 + |A|·|x|), bf16 2^-7 * |A|·|x| + 1e-5 (each plan's
    y rounded to bf16 from f32 sums taken in another order)."""
    assert got.dtype == want.dtype == dtype and got.device.type == "cuda"
    g = got.double().cpu().numpy()
    w = want.double().numpy()
    if dtype == torch.float32:
        assert np.max(np.abs(g - w)) <= 1e-5 * max(1.0, np.max(np.abs(w)))
    else:
        mag = _magnitude(csr, x)
        tol = (1e-12 * (1 + mag) if dtype == torch.float64
               else 2.0 ** -7 * mag + 1e-5)
        assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) - tol)


@pytest.mark.parametrize("name,x_mode,dtype", DIST_CASES)
def test_distributed_on_virtual_shards(name, x_mode, dtype, device):
    """DistributedSpMV on ["cuda:0"] * 4: with the counters reset, one
    op(x) launches the class kernels of every shard plan; y against the
    same operator on a CPU mesh (the plain versions) and the golden;
    the per-shard outputs on the card."""
    from tilespmv_tpu_torch.parallel import DistributedSpMV, make_mesh
    csr = generate.get_matrix(name)
    op = DistributedSpMV(csr, mesh=make_mesh(4, devices=VIRTUAL4),
                         x_mode=x_mode, dtype=dtype)
    cpu = DistributedSpMV(csr, mesh=make_mesh(4, devices=["cpu"] * 4),
                          x_mode=x_mode, dtype=dtype)
    assert op.x_mode == cpu.x_mode
    x = _bench_x(csr.n).astype(np.float64)
    kernels.reset_launch_counts()
    y = op(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    shards = op.shards + (op.foreign_shards or [])
    want = {k + _SFX[dtype] for sh in shards
            for k, cls in _classes(sh.device_plan()).items()
            if any(c is not None for c in cls)}
    assert want and all(counts[k] for k in want), (want, counts)
    _dist_close(y, cpu(x), csr, x, dtype)
    gold = csr.matvec(x)
    if dtype == torch.float32:
        np.testing.assert_allclose(y.cpu().numpy(), gold, rtol=2e-4,
                                   atol=1e-4)
    elif dtype == torch.float64:
        mag = _magnitude(csr, x)
        assert (np.abs(y.cpu().numpy() - gold) / (1 + mag)).max() <= 1e-12
    elif x_mode != "halo":
        _bf16_gate(y, gold)
    blocks = op.shard_outputs(x)
    assert [b.device for b in blocks] == op.mesh.flat()
    assert torch.equal(torch.cat(blocks)[: csr.m], op(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_distributed2d_on_virtual_shards(dtype, device):
    from tilespmv_tpu_torch.parallel import DistributedSpMV2D, make_mesh2d
    csr = generate.mixed_structure(4096, 8192, seed=5)
    op = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 2, devices=VIRTUAL4),
                           dtype=dtype)
    cpu = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 2,
                                                   devices=["cpu"] * 4),
                            dtype=dtype)
    x = _bench_x(csr.n).astype(np.float64)
    kernels.reset_launch_counts()
    y = op(x)
    torch.cuda.synchronize()
    assert any(kernels.launch_counts().values())
    _dist_close(y, cpu(x), csr, x, dtype)
    gold = csr.matvec(x)
    mag = _magnitude(csr, x)
    assert (np.abs(y.cpu().numpy() - gold) / (1 + mag)).max() <= (
        1e-12 if dtype == torch.float64 else 1e-4)


def test_distributed_timing_and_sweep(device):
    """time_op on four virtual shards: a CUDA graph of op(x) calls
    (graph ms > 0, within the eager time); the scaling sweep at 1, 2
    and 4 virtual shards."""
    from tilespmv_tpu_torch.bench.scaling import scaling_sweep, time_op
    from tilespmv_tpu_torch.parallel import DistributedSpMV, make_mesh
    csr = generate.get_matrix("mixed_medium")
    op = DistributedSpMV(csr, mesh=make_mesh(4, devices=VIRTUAL4),
                         x_mode="halo")
    ms, eager = time_op(op, _bench_x(csr.n), reps=3, iters=5)
    assert 0 < ms <= eager
    pts = scaling_sweep(csr, device_counts=[1, 2, 4], devices=VIRTUAL4,
                        reps=3, iters=5)
    assert [p.n_devices for p in pts] == [1, 2, 4]
    assert all(p.ms > 0 for p in pts) and pts[0].efficiency == 1.0


@pytest.mark.parametrize("name", ["banded_medium", "mixed_medium"])
def test_distributed_across_cards(name, device):
    """Over every visible card (make_mesh(), make_mesh2d(2, n / 2)),
    where there are two or more: the 1-D operator in each x mode and the
    2-D one launch their shards' class kernels, y equals the
    single-device operator's within 1e-5 * max(1, max|y|) and passes
    the golden, each row block lies on its card; time_op times the calls
    by events on every card."""
    from tilespmv_tpu_torch.bench.scaling import time_op
    from tilespmv_tpu_torch.parallel import (DistributedSpMV,
                                             DistributedSpMV2D, make_mesh,
                                             make_mesh2d)
    ncard = torch.cuda.device_count()
    if ncard < 2:
        pytest.skip("needs two or more cards")
    csr = generate.get_matrix(name)
    x = _bench_x(csr.n)
    y1 = TileSpMV(csr, device=device)(x).cpu().numpy()
    ops = [DistributedSpMV(csr, mesh=make_mesh(), x_mode=m)
           for m in ("allgather", "replicated", "halo")]
    if ncard % 2 == 0:
        ops.append(DistributedSpMV2D(csr, mesh=make_mesh2d(2, ncard // 2)))
    for op in ops:
        kernels.reset_launch_counts()
        y = op(x)
        for d in range(ncard):
            torch.cuda.synchronize(d)
        assert any(kernels.launch_counts().values())
        assert y.device == torch.device("cuda", 0)
        err = np.max(np.abs(y.cpu().numpy() - y1))
        assert err <= 1e-5 * max(1.0, np.max(np.abs(y1)))
        np.testing.assert_allclose(y.cpu().numpy(), csr.matvec(x),
                                   rtol=2e-4, atol=1e-4)
        blocks = op.shard_outputs(x)
        assert {b.device.index for b in blocks} == (
            set(range(ncard)) if len(blocks) == ncard
            else set(range(0, ncard, ncard // 2)))
        ms, eager = time_op(op, x, reps=3, iters=5)
        assert ms == eager > 0
