"""TileSpMV(..., max_cols_per_plan=) against tilespmv_tpu's column
partitioning: the same parts (width (limit // B) * B), each part's plan
bit-equal to the reference's part, partial y's summed by `forward` and
`matmat`, `shape`, `flops()`, `bytes_accessed()` and `summary` over the
whole operator, `.T` from the source CSR, the parts moved by `.to()`,
`device_plan()` refused, and the harness and profiling over the parts
(the reference's tests/test_plan_spmv.py and tests/test_edges.py cases,
mirrored). Without the argument the port does not partition: a matrix
wider than the reference's 2^21-column limit runs as one plan (the
card's kernels read x from global memory; ROADMAP.md C).

Bounds: y within 1e-4 * (1 + |y_64|) of the float64 product (the
reference test's bound)."""
import numpy as np
import pytest
import torch

from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.spmv import TileSpMV as JTileSpMV
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.bench.harness import benchmark_op
from tilespmv_tpu_torch.core.convert import tile_create
from tilespmv_tpu_torch.interop import lane_plan_from_jax, spmv_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda.reference import plan_array
from tilespmv_tpu_torch.ops.plan import map_plan_arrays
from tilespmv_tpu_torch.utils import profiling
from tilespmv_tpu_torch.utils.profiling import op_classes, profile_engines

from test_torch_plan import assert_same

# the reference tests' matrix: 256 x 1024, 4 parts of 256 columns
ARGS = ((256, 1024), dict(seed=9))


def wide(gen):
    return gen.mixed_structure(*ARGS[0], **ARGS[1])


def rel_err(y, csr, x):
    ref = csr.to_dense().astype(np.float64) @ x
    return float(np.max(np.abs(np.asarray(y, np.float64) - ref)
                        / (1 + np.abs(ref))))


def numpy_plan(op):
    """A part's device plan as NumPy arrays."""
    plan = op.device_plan()
    if op.backend == "pallas":
        return t_lane.map_arrays(plan, lambda _, a: plan_array(a))
    return map_plan_arrays(plan, lambda _, a: plan_array(a))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_parts_match_the_reference(backend):
    csr = wide(t_gen)
    op = TileSpMV(csr, device="cpu", backend=backend, max_cols_per_plan=256)
    jop = JTileSpMV(wide(j_gen), backend=backend, max_cols_per_plan=256)
    assert op.parts is not None and len(op.parts) == len(jop._col_parts) == 4
    assert op._col_starts == jop._col_starts == [0, 256, 512, 768]
    carry = lane_plan_from_jax if backend == "pallas" else spmv_plan_from_jax
    for part, jpart in zip(op.parts, jop._col_parts):
        assert part.shape == (256, 256) and part.backend == backend
        assert_same(carry(jpart.plan), numpy_plan(part))
    assert op.shape == (256, 1024) and op.backend == backend
    assert op.flops() == 2 * csr.nnz and op.nnz == csr.nnz
    assert op.bytes_accessed() == sum(p.bytes_accessed() for p in op.parts)
    s = op.summary
    assert s["col_parts"] == 4 and s["nnz"] == csr.nnz
    assert (s["m"], s["n"]) == (256, 1024)
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    y = op(x)
    assert y.shape == (256,) and y.dtype == torch.float32
    assert rel_err(y.numpy(), csr, x) < 1e-4
    assert rel_err(np.asarray(jop(x)), csr, x) < 1e-4


@pytest.mark.parametrize("k", [2, 8])
def test_matmat_sums_the_parts(k):
    csr = wide(t_gen)
    op = TileSpMV(csr, device="cpu", max_cols_per_plan=256)
    xs = np.random.default_rng(k).uniform(-1, 1, (csr.n, k)).astype(
        np.float32)
    y = op.matmat(xs)
    assert y.shape == (256, k)
    assert torch.equal(op @ xs, y)
    for r in range(k):
        assert rel_err(y[:, r].numpy(), csr, xs[:, r]) < 1e-4


def test_limit_is_rounded_to_whole_tiles_and_dtypes_carry():
    csr = wide(t_gen)
    op = TileSpMV(csr, device="cpu", dtype=torch.float64,
                  max_cols_per_plan=300)          # 18 tiles: 288 columns
    assert op._col_starts == [0, 288, 576, 864]
    assert [p.shape[1] for p in op.parts] == [288, 288, 288, 160]
    x = np.random.default_rng(0).standard_normal(csr.n)
    y = op(x)
    assert y.dtype == torch.float64
    assert rel_err(y.numpy(), csr, x) < 1e-12
    # a limit at or above the width: one plan
    assert TileSpMV(csr, device="cpu", max_cols_per_plan=1024).parts is None


def test_module_api_over_the_parts():
    csr = wide(t_gen)
    op = TileSpMV(csr, device="cpu", max_cols_per_plan=512)
    names = dict(op.named_buffers())
    assert "parts.0.residual_val" in names and "parts.1.residual_val" in names
    assert op.to("cpu") is op and op.device == torch.device("cpu")
    with pytest.raises(ValueError, match="column-partitioned"):
        op.device_plan()
    with pytest.raises(ValueError, match="expected"):
        op(np.zeros(512))
    # .T from the source CSR: (1024, 256), one plan
    x = np.random.default_rng(2).uniform(-1, 1, csr.m).astype(np.float32)
    t = op.T
    assert t.shape == (1024, 256) and t.T is op
    ref = csr.to_dense().astype(np.float64).T @ x
    assert float(np.max(np.abs(t(x).numpy() - ref) / (1 + np.abs(ref)))) \
        < 1e-4
    # a TileMatrix that wide cannot be split
    with pytest.raises(ValueError, match="max_cols_per_plan"):
        TileSpMV(tile_create(csr), device="cpu", max_cols_per_plan=512)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_benchmark_and_profile_a_partitioned_operator(backend, monkeypatch):
    csr = wide(t_gen)
    op = TileSpMV(csr, device="cpu", backend=backend, max_cols_per_plan=512)
    res = benchmark_op(op, warmup=1, timed_reps=1, iters_per_rep=2)
    assert res.nnz == csr.nnz and res.ms > 0 and res.n == 1024
    if backend == "pallas":
        classes = op_classes(op)
        assert len(classes) == sum(len(op_classes(p)) for p in op.parts)
        # one call a class in place of the difference-method loops (1,800
        # calls a class): this checks the keys, not the timing
        monkeypatch.setattr(profiling, "_timed",
                            lambda fn, *args, **kw: (fn(*args), 1e-3)[1])
        prof = profile_engines(op)
        assert prof and all(k.startswith(("part0_", "part1_"))
                            for k in prof)
        assert {k.split("_", 1)[0] for k in prof} == {"part0", "part1"}


def test_no_partitioning_by_default_wider_than_the_reference_limit():
    """2^21 + 4096 columns: the reference splits into two parts (its
    MAX_COLS_PER_PLAN), the port runs one plan."""
    n = (1 << 21) + 4096
    csr = t_gen.rectangular(512, n, 4, seed=31)
    assert JTileSpMV.MAX_COLS_PER_PLAN == 1 << 21 < n
    op = TileSpMV(csr, device="cpu")
    assert op.parts is None and op.shape == (512, n)
    x = np.random.default_rng(5).uniform(-1, 1, n).astype(np.float32)
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    ref = np.bincount(rows, weights=csr.data * x[csr.indices].astype(
        np.float64), minlength=csr.m)
    y = op(x).numpy()
    assert float(np.max(np.abs(y - ref) / (1 + np.abs(ref)))) < 1e-4


@pytest.mark.parametrize("limit", [0, 1, 15])
def test_a_limit_below_the_tile_size_raises(limit):
    """A part holds whole tile columns: a limit below the tile size (16),
    0 included, raises ValueError (the reference reads 0 as its default
    and fails on 1..15 with a zero range step)."""
    with pytest.raises(ValueError, match="tile size"):
        TileSpMV(wide(t_gen), device="cpu", max_cols_per_plan=limit)
