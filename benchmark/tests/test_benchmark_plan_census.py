"""metrics/w_fill_pct.py and metrics/plan_mb.py: the program's plan
census read into the W-classes' fill and the plan's device MB, on a
faked census, and None from a program without the census, without the
module, before any plan, or (w_fill_pct) with no W-class."""
import sys

import pytest

from benchmark import harness

CENSUS = {
    "w64": dict(chunks=10, nnz=600, slots=1000, bytes=5_000_000),
    "w48": dict(chunks=2, nnz=150, slots=200, bytes=1_000_000),
    "stream": dict(chunks=3, nnz=250, slots=3072, bytes=2_500_000),
    "residual": dict(chunks=0, nnz=0, slots=0, bytes=0),
}


def _read(name):
    return harness.plugin("metrics", name).read(None)


def test_readers_read_a_faked_census(monkeypatch):
    from tilespmv_tpu_torch import spans
    monkeypatch.setattr(spans, "plan_census", lambda: CENSUS)
    assert _read("w_fill_pct") == pytest.approx(100 * 750 / 1200)
    assert _read("plan_mb") == pytest.approx(8.5)


def test_w_fill_pct_without_a_w_class(monkeypatch):
    from tilespmv_tpu_torch import spans
    census = {k: v for k, v in CENSUS.items() if not k.startswith("w")}
    monkeypatch.setattr(spans, "plan_census", lambda: census)
    assert _read("w_fill_pct") is None
    assert _read("plan_mb") == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["w_fill_pct", "plan_mb"])
def test_readers_give_none_without_the_census(name, monkeypatch):
    from tilespmv_tpu_torch import spans
    monkeypatch.setattr(spans, "plan_census", lambda: None)
    assert _read(name) is None
    monkeypatch.delattr(spans, "plan_census")
    assert _read(name) is None
    monkeypatch.setitem(sys.modules, "tilespmv_tpu_torch.spans", None)
    monkeypatch.delattr("tilespmv_tpu_torch.spans")
    assert _read(name) is None
