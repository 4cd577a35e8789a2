"""The kernels' yardstick on the CPU: reference.class_coo lists each plan
class's nonzeros, so that a plan's classes and its residual together
rebuild the matrix exactly, summed as a sparse matrix
(tests/test_torch_plan.py's archetypes, which between them give every
class kind, and a HYB matrix with a residual; f32 and f64 plans), and
utils.profiling's bound counts the bytes of a hand-counted class, and a
band class's with no column per entry."""
import numpy as np
import pytest
import scipy.sparse as sps

from tilespmv_tpu_torch.config import TileConfig
from tilespmv_tpu_torch.core.convert import tile_create
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops.cuda import reference, stream_plan
from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan
from tilespmv_tpu_torch.utils import profiling

# tests/test_torch_plan.py's CASES, by generator call
CASES = {
    "mixed": ("mixed_structure", (512, 512), dict(seed=1)),
    "banded": ("banded", (600, 600, 5), dict(seed=2)),
    "uniform": ("random_uniform", (512, 512, 0.003), dict(seed=3)),
    "powerlaw": ("power_law", (512, 512, 10), dict(seed=4)),
    "ell": ("ell_regular", (512, 512, 6), dict(seed=5)),
    "dense_blocks": ("dense_blocks", (512, 512), dict(num_blocks=96,
                                                      seed=6)),
    "full_rows": ("full_rows", (512, 512), dict(num_rows=4, seed=7)),
    "full_cols": ("full_cols", (512, 512), dict(num_cols=4, seed=8)),
    "partial_tiles": ("mixed_structure", (1000, 777), dict(seed=11)),
    "row_windows": ("banded", (256 * 16 * 2 + 160,) * 2 + (2,),
                    dict(seed=13)),
    "wide_w_class": ("block_random", (2048, 2048),
                     dict(density=0.05, fill=0.33, seed=5)),
}
HYB = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
DTYPES = {"f32": np.float32, "f64": np.float64}


def _plan_and_csr(name, dtype):
    if name == "hyb_residual":
        csr = generate.power_law(512, 512, 20, seed=14)
        tm = tile_create(csr, TileConfig(**HYB))
    else:
        fn, args, kw = CASES[name]
        csr = getattr(generate, fn)(*args, **kw)
        tm = tile_create(csr)
    return build_lane_plan(tm, compute_dtype=DTYPES[dtype]), csr


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES) + ["hyb_residual"])
def test_class_coo_rebuilds_the_matrix(name, dtype):
    plan, csr = _plan_and_csr(name, dtype)
    tplan = reference.to_torch(plan)
    classes = [c for c in (tplan.dense, tplan.band, *tplan.sparses,
                           tplan.stream, tplan.stream2, tplan.residual)
               if c is not None]
    got = sps.csr_matrix((csr.m, csr.n))
    for cls in classes:
        row, col, val = reference.class_coo(cls)
        assert val.dtype == DTYPES[dtype] and row.dtype == np.int64
        assert (val != 0).all()
        got = got + sps.csr_matrix(
            (val.astype(np.float64), (row, col)), shape=(csr.m, csr.n))
    want_val = (stream_plan.f64_plan_value(csr.data) if dtype == "f64"
                else csr.data.astype(np.float32).astype(np.float64))
    want = sps.csr_matrix((want_val, csr.indices, csr.indptr),
                          shape=(csr.m, csr.n))
    diff = (got - want).tocoo()
    assert diff.nnz == 0 or np.abs(diff.data).max() == 0
    assert got.nnz == np.count_nonzero(want_val)
    if name == "hyb_residual":
        assert plan.residual.val.size > 0


def test_class_coo_sees_every_class_kind():
    kinds = set()
    for name in sorted(CASES) + ["hyb_residual"]:
        plan, _ = _plan_and_csr(name, "f32")
        for cls in (plan.dense, plan.band, *plan.sparses, plan.stream,
                    plan.residual):
            if cls is not None and reference.class_coo(cls)[2].size:
                kinds.add(type(cls).__name__)
    assert kinds == {"DenseChunks", "BandChunks", "SparseChunks",
                     "StreamChunks", "ResidualEngine"}


@pytest.mark.parametrize("dtype,k,want", [("f32", 1, 72), ("f64", 1, 112),
                                          ("f32", 2, 96)])
def test_bound_counts_a_hand_counted_class(dtype, k, want):
    """4 entries over rows {0, 5, 9} and columns {3, 7, 100}: values and
    int32 columns 4 * (v + 4) B, row pointer 4 * (3 + 1) B, x and y
    v * (3 + 3) * k B."""
    row = np.array([0, 0, 5, 9])
    col = np.array([3, 7, 3, 100])
    st = stream_plan.build_stream_chunks(
        row, col, np.array([1.0, -2.0, 0.5, 3.0]), 128, span_rows=64,
        dual=False, compute_dtype=DTYPES[dtype])
    got = profiling.class_bound([st], k=k)
    vbytes = np.dtype(DTYPES[dtype]).itemsize
    assert got["bytes"] == want
    assert got["flops"] == 2 * 4 * k
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)
    assert profiling.csr_bound(4, 3, 3, vbytes, k) == got
    # operations bind where the bytes are few against the flops
    ops = profiling.roofline(1, 10 ** 9, 4)
    assert ops["bound_by"] == "operations"
    assert ops["bound_ms"] == pytest.approx(10 ** 9 / 67e12 * 1e3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 8])
def test_bound_prices_a_band_class_without_column_indices(dtype, k):
    """A band class's columns follow from each tile row's block column:
    its bound counts the nonzeros' values, its bloc, pb and cw arrays,
    and x and y once, not the int32 column and row pointer of a CSR, and
    none of the brick's zero slots."""
    plan, _ = _plan_and_csr("row_windows", dtype)   # 3 windows, C = 1
    band = plan.band
    row, col, val = reference.class_coo(band)
    vbytes = np.dtype(DTYPES[dtype]).itemsize
    nrows, ncols = np.unique(row).size, np.unique(col).size
    index = band.bloc.nbytes + band.pb.nbytes + band.cw.nbytes
    want = (val.size * vbytes + index + vbytes * (nrows + ncols) * k)
    got = profiling.class_bound([band], k=k)
    assert got["bytes"] == want < band.val.nbytes
    assert got["flops"] == 2 * val.size * k
    assert got == profiling.band_bound(val.size, nrows, ncols, vbytes,
                                       index, k)
    csr = profiling.csr_bound(val.size, nrows, ncols, vbytes, k)
    assert csr["bytes"] - got["bytes"] == 4 * val.size + 4 * (nrows + 1) \
        - index
