"""The cell hpcg104-f32.loop1 driven whole on the CPU at a small grid
through harness.run_cell: a sound run is correct and reports the cell's
end-to-end metrics; the bf16 control and each fault planted under
`TileSpMV.forward` (a step that returns its first y, half the rows
replaced by the mean of the rest, one entry of each y altered) are not
correct; a traced run reads the plan census (w_fill_pct, plan_mb) of the
f32 route's W-class."""
import pytest
from test_benchmark_check import _altered, _half, _stale

from benchmark import harness
from tilespmv_tpu_torch.ops.spmv import TileSpMV

MAN = harness.manifest()
NAME = "hpcg104-f32.loop1"
# a grid whose f32 plan is one W-class (w64) and nothing else
SMALL = dict(nx=16, ny=12, nz=20)


def _run(dtype=None, trace=False, seed=2 ** 31 + 17):
    cell, config, traffic = harness.resolve(NAME, MAN)
    return harness.run_cell(MAN, cell, dict(config, **SMALL), traffic, seed,
                            0.3, trace, "cpu", dtype=dtype)[0]


def test_the_cell_is_in_the_manifest():
    cell, config, traffic = harness.resolve(NAME, MAN)
    assert cell["chips"] == 1 and cell["traffic"] == "loop1"
    assert config["dtype"] == "float32" and config["generator"] == "hpcg27"
    assert (config["nx"], config["ny"], config["nz"]) == (200, 200, 200)
    assert config["control_dtype"] == "bfloat16"


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0
    check = res["check"]
    assert check["y_err"]["value"] <= check["y_err"]["limit"]
    want = {m["name"] for m in harness.cell_metrics(MAN, NAME, "end_to_end")}
    assert set(res["metrics"]) == want == {"spmv_ms", "iter_p95_ms",
                                           "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_bf16_control_is_not_correct():
    _, config, _ = harness.resolve(NAME, MAN)
    res = _run(dtype=config["control_dtype"])
    assert not res["correct"] and res["failed"] > 0
    assert res["check"]["y_err"]["value"] > 10 * res["check"]["y_err"]["limit"]


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(TileSpMV, "forward", fault(TileSpMV.forward))
    res = _run()
    assert not res["correct"] and res["failed"] > 0


def test_traced_run_reads_the_census():
    res = _run(trace=True)
    assert res["correct"]
    metrics = res["metrics"]
    assert 50 < metrics["w_fill_pct"]["value"] < 100
    assert metrics["w_fill_pct"]["unit"] == "%"
    assert metrics["plan_mb"]["value"] > 0 and metrics["plan_mb"]["unit"] == "MB"


@pytest.mark.parametrize("name", ["w_fill_pct", "plan_mb"])
def test_census_metrics_list_the_cell(name):
    m = next(m for m in MAN["per_layer"] if m["name"] == name)
    assert NAME in m["workloads"] and m["source"] == "program_counter"
    assert m["layer"] == "host planning" and m["moves"] == "spmv_ms"
