"""The program's spans and the planner's phase times (spans.py).

Without a profiler `span` hands out one shared no-op context and never
enters a profiler span. Under `torch.profiler` one call of a CPU
operator gives `tsp.forward` (`tsp.matmat`) holding `tsp.prep` (holding
`tsp.device_plan` at the operator's first call alone, where its call
state is built), the assembly's `tsp.prep`, one `tsp.launch.<class>`
per class of the plan in the main path's order, and `tsp.finish`; a
column part's spans sit inside the outer call's.
`TileSpMV(csr)` fills the four plan phases, which sum to the
constructor's wall time within 10%; `trace_context`'s Chrome trace holds
the spans.

Bounds: y within 1e-4 * (1 + |A|·|x|) of the float64 product (2^-7 for
bf16)."""
import json
import time

import numpy as np
import pytest
import torch

from tilespmv_tpu_torch import (CSRMatrix, TileConfig, TileSpMV,
                                csr_from_coo, spans)
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.utils import profiling

HYB = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)


def two_rate(seed=0):
    """16384 x 16384 COO-like entries: one every 8 rows, and 32 a row in
    the first 2048 rows, so the stream windows split into two classes
    (stream and stream2)."""
    rng = np.random.default_rng(seed)
    m = 16384
    rows = np.concatenate([np.arange(0, m, 8),
                           np.repeat(np.arange(2048), 32)])
    cols = rng.integers(0, m, rows.size)
    return csr_from_coo(m, m, rows, cols, rng.uniform(-1, 1, rows.size))


# name -> (matrix, TileConfig kwargs)
MATRICES = {
    "mixed": (lambda: generate.mixed_structure(512, 512, seed=7), {}),
    "banded": (lambda: generate.banded(1024, 1024, 7, seed=22), {}),
    "w16": (lambda: generate.random_uniform(512, 512, 0.003, seed=3), {}),
    "w96": (lambda: generate.block_random(2048, 2048, density=0.05,
                                          fill=0.33, seed=5), {}),
    "hyb": (lambda: generate.power_law(512, 512, 20, seed=14), HYB),
    "two_rate": (two_rate, {}),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}
# (matrix, dtype) -> the classes its plan has, in the main path's order
FORWARD_CASES = {
    ("mixed", "f32"): ["dense", "stream"],
    ("banded", "f32"): ["band"],
    ("w16", "f32"): ["sparse_w16"],
    ("w96", "f32"): ["dense", "sparse_w96"],
    ("hyb", "f32"): ["dense", "sparse_w16"],
    ("two_rate", "f32"): ["stream", "stream2"],
    ("mixed", "f64"): ["dense", "stream"],
    ("banded", "f64"): ["band"],
    ("hyb", "f64"): ["dense"],
    ("hyb", "bf16"): ["dense", "sparse_w16"],
    ("two_rate", "bf16"): ["stream", "stream2"],
}


def operator(name, dtype="f32", **kw):
    make, cfg = MATRICES[name]
    csr = make()
    return csr, TileSpMV(csr, device="cpu", dtype=DTYPES[dtype],
                         config=TileConfig(**cfg), **kw)


def classes(op) -> list:
    plan = op.device_plan()
    return ([k for k, c in (("dense", plan.dense), ("band", plan.band))
             if c is not None]
            + [f"sparse_w{s.width}" for s in plan.sparses]
            + [k for k, c in (("stream", plan.stream),
                              ("stream2", plan.stream2)) if c is not None])


def span_tree(prof) -> list:
    """The `tsp.*` events of a profile as [(name, [children...]), ...],
    each under its innermost `tsp.*` ancestor, in start order."""
    evs = sorted((e for e in prof.events() if e.name.startswith("tsp.")),
                 key=lambda e: e.time_range.start)
    kids = {id(e): [] for e in evs}
    roots = []
    for e in evs:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("tsp."):
            p = p.cpu_parent
        (kids[id(p)] if p is not None else roots).append(e)

    def tree(e):
        return (e.name, [tree(k) for k in kids[id(e)]])
    return [tree(e) for e in roots]


def call_tree(outer, classes_, first=True):
    """The spans of one call over a plan with `classes_`: the first
    builds the call state, in `tsp.device_plan`."""
    return (outer, [prep(first), *assembly(classes_)])


def prep(first):
    return ("tsp.prep", [("tsp.device_plan", [])] if first else [])


def assembly(classes_):
    return [("tsp.prep", []),
            *[(f"tsp.launch.{c}", []) for c in classes_],
            ("tsp.finish", [])]


def profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, span_tree(prof)


def assert_product(csr, x, y, dtype="f32"):
    absa = CSRMatrix(csr.shape, csr.indptr, csr.indices, np.abs(csr.data))
    x64 = x.double().numpy().reshape(csr.n, -1)
    want = np.stack([csr.matvec(c) for c in x64.T], axis=1)
    scale = 1 + np.stack([absa.matvec(np.abs(c)) for c in x64.T], axis=1)
    tol = 2 ** -7 if dtype == "bf16" else 1e-4
    got = y.double().numpy().reshape(want.shape)
    assert np.all(np.abs(got - want) <= tol * scale)


def test_no_profiler_no_record_function(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("tsp.forward") is spans.span("tsp.prep")
    with pytest.raises(ValueError, match="passes through"):
        with spans.span("tsp.forward"):
            raise ValueError("passes through")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(spans, "_RECORD", refuse)
    csr, op = operator("mixed")
    x = torch.linspace(-1, 1, csr.n)
    assert_product(csr, x, op(x))
    xs = torch.ones(csr.n, 8)
    assert_product(csr, xs, op.matmat(xs))
    with pytest.raises(AssertionError, match="record_function"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            op(x)


@pytest.mark.parametrize("name,dtype", sorted(FORWARD_CASES))
def test_forward_spans_nest(name, dtype):
    csr, op = operator(name, dtype)
    assert classes(op) == FORWARD_CASES[name, dtype]
    if name == "hyb":
        assert op.device_plan().residual.val.shape[0] > 0
    x = torch.linspace(-1, 1, csr.n).to(DTYPES[dtype])
    (y, y2), tree = profiled(lambda: (op(x), op(x)))
    assert tree == [call_tree("tsp.forward", FORWARD_CASES[name, dtype],
                              first)
                    for first in (True, False)]
    assert_product(csr, x, y, dtype)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("dtype,k", [("f32", 8), ("f64", 3)])
def test_matmat_spans_nest(dtype, k):
    """f32 runs the fused SpMM once; f64 one SpMV a column, each with its
    own assembly spans."""
    csr, op = operator("mixed", dtype)
    x = torch.rand(csr.n, k, generator=torch.Generator().manual_seed(1),
                   dtype=DTYPES[dtype])
    (y, y2), tree = profiled(lambda: (op.matmat(x), op.matmat(x)))
    per = 1 if dtype == "f32" else k
    assert tree == [("tsp.matmat",
                     [prep(first), *assembly(["dense", "stream"]) * per])
                    for first in (True, False)]
    assert_product(csr, x, y)
    assert torch.equal(y, y2)


def test_column_parts_nest_in_the_outer_call():
    csr = generate.mixed_structure(256, 1024, seed=9)
    op = TileSpMV(csr, device="cpu", max_cols_per_plan=256)
    assert len(op.parts) == 4
    x = torch.linspace(-1, 1, csr.n)
    (y, _), tree = profiled(lambda: (op(x), op(x)))
    assert tree == [("tsp.forward",
                     [("tsp.prep", []),
                      *[call_tree("tsp.forward", classes(p), first)
                        for p in op.parts]])
                    for first in (True, False)]
    assert_product(csr, x, y)


def test_xla_backend_has_no_class_spans():
    csr = generate.mixed_structure(512, 512, seed=7)
    op = TileSpMV(csr, device="cpu", backend="xla")
    x = torch.linspace(-1, 1, csr.n)
    (y, _), tree = profiled(lambda: (op(x), op(x)))
    assert tree == [("tsp.forward", [prep(first)])
                    for first in (True, False)]
    assert_product(csr, x, y)


@pytest.mark.parametrize("name,dtype,stream", [
    ("w96", "f32", False), ("two_rate", "f32", True),
    ("mixed", "bf16", True)])
def test_plan_phases_sum_to_the_constructor(name, dtype, stream):
    make, cfg = MATRICES[name]
    csr = make()
    spans.reset_plan_phases()
    t = time.perf_counter()
    TileSpMV(csr, device="cpu", dtype=DTYPES[dtype],
             config=TileConfig(**cfg))
    wall = time.perf_counter() - t
    got = spans.plan_phases()
    assert set(got) == set(spans.PLAN_PHASES)
    assert all(v >= 0 for v in got.values())
    assert (got["plan.stream"] > 0) == stream
    assert got["plan.convert"] > 0 and got["plan.classes"] > 0
    assert got["plan.upload"] > 0
    assert 0.9 * wall <= sum(got.values()) <= wall


def test_nested_phases_count_once():
    spans.reset_plan_phases()
    with spans.phase("plan.classes"):
        time.sleep(0.02)
        with spans.phase("plan.stream"):
            time.sleep(0.03)
            with spans.phase("plan.stream"):
                time.sleep(0.01)
    got = spans.plan_phases()
    assert got["plan.stream"] == pytest.approx(0.04, abs=0.02)
    assert got["plan.classes"] == pytest.approx(0.02, abs=0.02)
    assert got["plan.convert"] == got["plan.upload"] == 0.0
    with pytest.raises(ValueError):
        with spans.phase("plan.upload"):
            raise ValueError("the phase still counts")
    assert spans.plan_phases()["plan.upload"] > 0
    spans.reset_plan_phases()
    assert spans.plan_phases() == dict.fromkeys(spans.PLAN_PHASES, 0.0)


def test_phases_add_up_across_operators():
    csr = generate.mixed_structure(256, 1024, seed=9)
    spans.reset_plan_phases()
    op = TileSpMV(csr, device="cpu")
    one = spans.plan_phases()
    _ = op.T
    both = spans.plan_phases()
    assert all(both[k] > one[k] for k in
               ("plan.convert", "plan.classes", "plan.upload"))


def test_phases_are_spans_under_a_profiler():
    csr = generate.mixed_structure(512, 512, seed=7)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TileSpMV(csr, device="cpu")
    names = [e.name for e in prof.events() if e.name.startswith("plan.")]
    assert sorted(set(names)) == sorted(spans.PLAN_PHASES)


def test_trace_context_writes_the_spans(tmp_path):
    csr, op = operator("mixed")
    with profiling.trace_context(tmp_path):
        op(torch.linspace(-1, 1, csr.n))
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"tsp.forward", "tsp.prep", "tsp.device_plan",
            "tsp.launch.dense", "tsp.launch.stream",
            "tsp.finish"} <= names
