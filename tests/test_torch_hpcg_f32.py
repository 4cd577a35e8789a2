"""HPCG's 27-point stencil in float32 (HPG-MxP's inner solve) through
`TileSpMV(csr, dtype=torch.float32)` on the CPU, against the plain
float64 product (`plain_reference.csr_matvec`), which shares no code
with the tiled path.

The matrix is the benchmark's own (`benchmark/generators/hpcg27.py`).
Bound: |y - y_ref| <= 1e-5 * (|A|·|x|)_row, for SpMV and for `matmat`
at k = 4 column by column; f32 sums of at most 27 products land near
1e-7 of that scale, and the same operator in bf16 lands near 3e-3, past
the bound. The f32 plan routes the stencil into W-classes (`w{W}`), and
the plan's census (`spans.plan_census()`, read from the plan's summary)
accounts for every nonzero and for the bytes each class's kernel
streams, a column-partitioned operator's over all its parts; it is
counted once when the operator is built: a call neither counts it again
nor does any other work for it. `CSRMatrix.matvec` is the plain product
in the matrix's own dtype."""
import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from test_torch_spans import call_tree, classes, profiled
from tilespmv_tpu_torch import CSRMatrix, TileSpMV, plain_reference, spans
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops import spmv as spmv_mod
from tilespmv_tpu_torch.ops.cuda.lane_plan import LanePlan

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRIDS = [(12, 12, 12), (16, 12, 20), (33, 33, 33)]
TOL = 1e-5
K = 4


def _generator():
    spec = importlib.util.spec_from_file_location(
        "hpcg27", ROOT / "benchmark" / "generators" / "hpcg27.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stencil(nx, ny, nz, seed=3):
    """(CSRMatrix, (indptr, indices, data) tensors) of the f32 stencil."""
    gen = torch.Generator().manual_seed(seed)
    m, n, indptr, indices, data = _generator().generate(
        dict(nx=nx, ny=ny, nz=nz), gen, "cpu", torch.float32)
    csr = CSRMatrix((m, n), indptr.numpy(), indices.numpy(), data.numpy())
    return csr, (indptr, indices, data)


def rel_err(arrays, x, y) -> float:
    """max over rows (and columns) of |y - A x| / (|A|·|x|)."""
    indptr, indices, data = arrays
    want = plain_reference.csr_matvec(indptr, indices, data, x)
    scale = plain_reference.csr_matvec(indptr, indices, data.abs(),
                                       x.double().abs())
    return float(((y.double() - want).abs() / scale).max())


def xs(n, kind, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shape = (n,) if kind == "spmv" else (n, K)
    return (torch.rand(shape, generator=gen, dtype=torch.float64) * 2
            - 1).to(dtype)


@pytest.mark.parametrize("kind", ["spmv", "matmat"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_f32_operator_matches_the_plain_product(grid, kind):
    csr, arrays = stencil(*grid)
    op = TileSpMV(csr, device="cpu", dtype=torch.float32)
    x = xs(csr.n, kind, torch.float32)
    if kind == "spmv":
        y = op(x)
        assert y.dtype == torch.float32 and y.shape == (csr.m,)
        assert rel_err(arrays, x, y) <= TOL
    else:
        y = op.matmat(x)
        assert y.dtype == torch.float32 and y.shape == (csr.m, K)
        for c in range(K):
            assert rel_err(arrays, x[:, c], y[:, c]) <= TOL


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_bf16_operator_fails_the_f32_bound(grid):
    """The nearest lower precision is told apart by the bound: it is the
    benchmark's control for this configuration."""
    csr, arrays = stencil(*grid)
    op = TileSpMV(csr, device="cpu", dtype=torch.bfloat16)
    x = xs(csr.n, "spmv", torch.bfloat16)
    assert rel_err(arrays, x, op(x)) > 10 * TOL


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_stencil_27_is_the_benchmark_stencil(grid):
    """io.generate.stencil_27, which scripts/sparse_probes.py runs as
    hpcg<N>, holds the benchmark generator's rows and columns."""
    csr, (indptr, indices, _) = stencil(*grid)
    got = generate.stencil_27(*grid, dtype=np.float32)
    assert got.shape == csr.shape and got.data.dtype == np.float32
    assert np.array_equal(got.indptr, indptr.numpy())
    assert np.array_equal(got.indices, indices.numpy())
    assert got.data.shape == got.indices.shape


def test_plain_reference_imports_only_torch():
    path = ROOT / "tilespmv_tpu_torch" / "plain_reference.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            mods.add(node.module.split(".")[0])
    assert mods == {"torch"}


def test_csr_matrix_matvec_is_the_plain_product():
    """CSRMatrix.matvec is csr_matvec in the dtype of the values and x."""
    csr, arrays = stencil(9, 8, 7)
    for dtype in (torch.float32, torch.float64):
        x = xs(csr.n, "spmv", dtype)
        got = csr.matvec(x.numpy())
        want = plain_reference.csr_matvec(*arrays, x, dtype=dtype)
        assert got.dtype == x.numpy().dtype and got.dtype == (
            want.numpy().dtype)
        assert torch.equal(torch.from_numpy(got), want)


def test_plain_reference_is_the_dense_product():
    csr, arrays = stencil(5, 4, 3)
    dense = torch.from_numpy(csr.to_dense()).double()
    x = xs(csr.n, "matmat", torch.float64)
    got = plain_reference.csr_matvec(*arrays, x)
    assert torch.allclose(got, dense @ x, rtol=1e-14, atol=1e-14)
    assert torch.allclose(plain_reference.csr_matvec(*arrays, x[:, 0]),
                          dense @ x[:, 0], rtol=1e-14, atol=1e-14)


@pytest.fixture(scope="module")
def grid32():
    csr, _ = stencil(32, 32, 32)
    op = TileSpMV(csr, device="cpu", dtype=torch.float32)
    return csr, op, spans.plan_census()


def test_f32_route_puts_the_stencil_in_a_w_class(grid32):
    csr, op, census = grid32
    assert any(c.startswith("sparse_w") for c in classes(op))
    w = [c for kind, c in census.items() if kind.startswith("w")]
    assert len(w) >= 1 and "dense" not in census
    assert sum(c["nnz"] for c in w) >= 0.9 * csr.nnz
    for c in w:
        assert 0 < c["nnz"] < c["slots"]


def _streamed(cls) -> int:
    """The bytes of the arrays the class's kernel streams, counted here
    from the device plan: values and their per-entry or per-lane
    indices, a stream class's `erow` and not its round planes."""
    names = {"ResidualEngine": ("val", "row", "col"),
             "BandChunks": ("val", "bloc"),
             "StreamChunks": ("val", "vidx", "erow")}.get(
                 type(cls).__name__, ("val", "meta"))
    return sum(getattr(cls, n).numel() * getattr(cls, n).element_size()
               for n in names)


def test_census_accounts_for_every_nonzero_and_buffer(grid32):
    csr, op, census = grid32
    assert sum(c["nnz"] for c in census.values()) == csr.nnz == op.nnz
    plan = op.device_plan()
    streamed = [plan.residual, *plan.sparses] + [
        c for c in (plan.dense, plan.band, plan.stream, plan.stream2)
        if c is not None]
    assert sum(c["bytes"] for c in census.values()) == sum(
        map(_streamed, streamed)) < sum(
            b.numel() * b.element_size() for b in op.buffers())
    for s in plan.sparses:
        c = census[f"w{s.width}"]
        assert c["chunks"] == s.val.shape[0]
        assert c["slots"] == s.val.numel()
        assert c["bytes"] == _streamed(s)
    assert census["residual"]["chunks"] == plan.residual.val.shape[0]


def test_census_sums_the_column_parts():
    """A column-partitioned operator's census is its parts' together, and
    it is the operator's own: its parts, built first, do not leave theirs
    behind."""
    csr, _ = stencil(16, 12, 20)
    op = TileSpMV(csr, device="cpu", dtype=torch.float32,
                  max_cols_per_plan=1024)
    census = spans.plan_census()
    assert len(op.parts) == 4
    assert sum(c["nnz"] for c in census.values()) == csr.nnz
    parts = op.summary["classes"]
    assert {c["part"] for c in parts} == set(range(4))
    for key in ("nnz", "slots", "bytes"):
        assert sum(c[key] for kind, c in census.items()
                   if kind != "residual") == sum(c[key] for c in parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_census_is_counted_once_at_registration(dtype, monkeypatch):
    """One plan summary counted per operator built, none in a call; a
    call's spans and profiled operations are those of an operator whose
    census was never recorded; the census read is a copy."""
    csr, _ = stencil(16, 12, 20)
    counted = []
    summary = LanePlan.summary

    def counting(plan):
        counted.append(1)
        return summary(plan)
    monkeypatch.setattr(LanePlan, "summary", counting)
    op = TileSpMV(csr, device="cpu", dtype=dtype)
    assert len(counted) == 1
    first = spans.plan_census()
    x = xs(csr.n, "spmv", dtype)
    op(x)
    _, tree = profiled(lambda: op(x))
    ops = _profiled_ops(lambda: op(x))
    assert len(counted) == 1 and spans.plan_census() == first
    assert tree == [call_tree("tsp.forward", classes(op), first=False)]
    first["residual"]["nnz"] = -1
    assert spans.plan_census()["residual"]["nnz"] == 0

    monkeypatch.setattr(spmv_mod, "record_plan", lambda summary: None)
    spans.record_plan(None)
    bare = TileSpMV(csr, device="cpu", dtype=dtype)
    assert spans.plan_census() is None
    bare(x)
    assert _profiled_ops(lambda: bare(x)) == ops


def test_xla_plan_has_no_census():
    csr, _ = stencil(6, 5, 7)
    TileSpMV(csr, device="cpu", dtype=torch.float32)
    assert spans.plan_census()
    TileSpMV(csr, device="cpu", dtype=torch.float32, backend="xla")
    assert spans.plan_census() is None


def _profiled_ops(fn) -> list:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)]
