"""The lane planner's routing arms (tilespmv_tpu_torch/ops/cuda/lane_plan.py:
ROUTE_MODE, ROUTE_FORCE_THETA, ROUTE_SAMPLE_TILES, _route_classes and
LAST_ABSORB_ESTIMATE) against tilespmv_tpu's: lane plans bit-equal under
the cost-model arm, its 1-in-8 window sample and every forced theta, with
the native library on and off; the absorb estimate equal; the model-
routed plan's y from the plain versions within 1e-5 * max(1, max|y|) of
the reference's operator in interpret mode (the parity rules of
ROADMAP.md part 1)."""
import numpy as np
import pytest
import torch

from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.io.mmio import CSRMatrix as JCSR
from tilespmv_tpu.ops import spmv as j_spmv
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.io.mmio import CSRMatrix as TCSR
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane

from test_torch_plan import CASES, assert_same, make, native_mode  # noqa: F401

NB = len(t_lane.W_CHOICES)
# (label, ROUTE_MODE, ROUTE_FORCE_THETA, ROUTE_SAMPLE_TILES): the model
# arm, the model arm costing a 1-in-8 window sample (a real sample on the
# cases of more than one 256-tile-row window: row_windows, hypersparse,
# rectangular), and each forced theta
ROUTINGS = ([("model", "model", None, t_lane.ROUTE_SAMPLE_TILES),
             ("model_sampled", "model", None, 64)]
            + [(f"theta{t}", "fixed", t, t_lane.ROUTE_SAMPLE_TILES)
               for t in range(NB + 1)])


def route(monkeypatch, mode, theta, sample):
    """Set the routing globals of both packages."""
    for mod in (j_lane, t_lane):
        monkeypatch.setattr(mod, "ROUTE_MODE", mode)
        monkeypatch.setattr(mod, "ROUTE_FORCE_THETA", theta)
        monkeypatch.setattr(mod, "ROUTE_SAMPLE_TILES", sample)


def plans(jtm, ttm, **opts):
    """Both packages' plans of one tile matrix, and their absorb
    estimates (None where the COO decision did not run)."""
    for mod in (j_lane, t_lane):
        mod.LAST_ABSORB_ESTIMATE = None
    jplan = j_lane.build_lane_plan(jtm, **opts)
    tplan = t_lane.build_lane_plan(ttm, **opts)
    return (lane_plan_from_jax(jplan), tplan, j_lane.LAST_ABSORB_ESTIMATE,
            t_lane.LAST_ABSORB_ESTIMATE)


def classes(plan) -> list:
    return ([f"W{s.width}" for s in plan.sparses]
            + (["dense"] if plan.dense is not None else []))


@pytest.mark.parametrize("name", sorted(CASES))
def test_routed_plans_bit_equal(name, native_mode, monkeypatch):
    """Every routing of ROUTINGS, and force_t's fixed arm under the model
    mode (the distributed layer's shard plans must not route apart)."""
    jtm = j_convert.tile_create(make(j_gen, name))
    ttm = t_convert.tile_create(make(t_gen, name))
    for label, mode, theta, sample in ROUTINGS:
        route(monkeypatch, mode, theta, sample)
        want, got, jest, test = plans(jtm, ttm)
        assert_same(got, want, f"{name} {label}")
        assert test == jest, label
        if theta is not None:
            # bands >= theta densify; the W classes left are all below
            assert all(t_lane.W_CHOICES.index(s.width) < theta
                       for s in got.sparses), label
    route(monkeypatch, "model", None, t_lane.ROUTE_SAMPLE_TILES)
    want, got, _, _ = plans(jtm, ttm, force_t=128)
    assert_same(got, want, f"{name} force_t under model")
    route(monkeypatch, "fixed", None, t_lane.ROUTE_SAMPLE_TILES)
    assert_same(plans(jtm, ttm, force_t=128)[1], got,
                f"{name} force_t: the fixed arm")


def test_model_arm_routes_apart_from_fixed(monkeypatch):
    """The arms differ on real inputs (so the tests above compare two
    routings, not one): on diag_plus_hubs the model arm densifies the W24
    tiles the fixed arm keeps."""
    ttm = t_convert.tile_create(make(t_gen, "diag_plus_hubs"))
    route(monkeypatch, "fixed", None, t_lane.ROUTE_SAMPLE_TILES)
    fixed = classes(t_lane.build_lane_plan(ttm))
    route(monkeypatch, "model", None, t_lane.ROUTE_SAMPLE_TILES)
    model = classes(t_lane.build_lane_plan(ttm))
    assert fixed == ["W24", "dense"] and model == ["dense"]


def packed_population(cls):
    """tests/test_classes_edge.py::test_cost_model_routing_arm's matrix:
    1024 tiles of 80 entries each, 16 tile-rows of 64 tiles."""
    rng = np.random.default_rng(11)
    rows, cols = [], []
    for t in range(1024):
        sl = rng.choice(256, 80, replace=False)
        rows.append((t // 64) * 16 + sl // 16)
        cols.append((t % 64) * 16 + sl % 16)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.standard_normal(rows.size)
    m, n = int(rows.max()) + 1, int(cols.max()) + 1
    order = np.lexsort((cols, rows))
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=m))]).astype(np.int64)
    return cls((m, n), indptr, cols[order].astype(np.int64), vals[order])


def test_packed_population_densifies(native_mode, monkeypatch):
    route(monkeypatch, "model", None, t_lane.ROUTE_SAMPLE_TILES)
    jtm = j_convert.tile_create(packed_population(JCSR))
    ttm = t_convert.tile_create(packed_population(TCSR))
    want, got, _, _ = plans(jtm, ttm)
    assert_same(got, want)
    assert classes(got) == ["dense"]
    # the fixed arm keeps 80-entry tiles in the W96 class
    route(monkeypatch, "fixed", None, t_lane.ROUTE_SAMPLE_TILES)
    assert "W96" in classes(t_lane.build_lane_plan(ttm))


@pytest.mark.parametrize("name", ["diag_plus_hubs", "wide_w_class",
                                  "rectangular", "packed"])
def test_model_routed_y_matches_interpret(name, monkeypatch):
    """The model-routed plan run by the plain versions (TileSpMV on the
    CPU) against the reference's operator on its own plan in interpret
    mode, and the golden."""
    route(monkeypatch, "model", None, t_lane.ROUTE_SAMPLE_TILES)
    if name == "packed":
        jc, tc = packed_population(JCSR), packed_population(TCSR)
    else:
        jc, tc = make(j_gen, name), make(t_gen, name)
    jplan = j_lane.build_lane_plan(j_convert.tile_create(jc))
    tplan = t_lane.build_lane_plan(t_convert.tile_create(tc))
    assert_same(tplan, lane_plan_from_jax(jplan))
    x = np.random.default_rng(3).uniform(-1, 1, tc.n).astype(np.float32)
    got = TileSpMV.from_plan(tplan, device="cpu")(torch.from_numpy(x))
    want = np.asarray(j_spmv.TileSpMV.from_plan(jplan)(x))
    got = got.numpy()
    err = float(np.max(np.abs(got - want)))
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(want)))), err
    np.testing.assert_allclose(got, tc.to_dense() @ x.astype(np.float64),
                               rtol=2e-4, atol=1e-4)


def test_calibrate_cost_script_on_the_cpu(capsys, monkeypatch):
    """tilespmv_tpu_torch/scripts/calibrate_cost.py (the reference's
    scripts/calibrate_cost.py) on the plain versions: a line per forced
    theta and per automatic arm, each arm's regret against the best
    theta, the model arm's per-class times; the routing globals
    restored; without a card it exits 2 unless asked for the CPU."""
    from tilespmv_tpu_torch.scripts import calibrate_cost
    before = (t_lane.ROUTE_MODE, t_lane.ROUTE_FORCE_THETA)
    out = calibrate_cost.calibrate("mixed_small", device="cpu", iters=1)
    assert (t_lane.ROUTE_MODE, t_lane.ROUTE_FORCE_THETA) == before
    assert sorted(out["theta"]) == list(range(NB + 1))
    best = min(ms for ms, _ in out["theta"].values())
    for arm in ("fixed", "model"):
        ms, regret, _ = out[arm]
        assert regret == pytest.approx(ms / best - 1.0)
    text = capsys.readouterr().out
    assert text.count("mixed_small theta=") == NB + 1
    assert "auto[fixed]" in text and "auto[model]" in text
    assert "dense" in text.split("auto[model]")[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate_cost.main(["mixed_small"]) == 2
