"""The check that decides `correct`, driven through a whole run on the
CPU at a small size: a sound run is correct; the control (the program's
own lower-precision path) and each fault the cells can have, planted
under the timed path, come out as not correct. A one-card cell has no
exchange between cards to leave out."""
import json

import pytest
import torch

from benchmark import harness
from tilespmv_tpu_torch.ops.spmv import TileSpMV

MAN = harness.manifest()
SMALL = {"kron21": dict(scale=9), "hpcg104": dict(nx=6, ny=5, nz=7)}
# the block methods' loop (traffic/block8.json, matmat through the spmm
# readers) is in no cell yet; a later cell adds it by entries alone
BLOCK8 = {"name": "kron21.block8", "config": "kron21", "traffic": "block8",
          "chips": 1, "why": "block methods on a graph"}
MAN_BLOCK8 = dict(MAN, workloads=MAN["workloads"] + [BLOCK8])
CELLS = [w["name"] for w in MAN["workloads"]]
LOOPS = CELLS + [BLOCK8["name"]]


def _run(name, seed=2 ** 31 + 11, dtype=None, seconds=0.3, trace=False):
    cell, config, traffic = harness.resolve(name, MAN_BLOCK8)
    config = dict(config, **SMALL[cell["config"]])
    return harness.run_cell(MAN_BLOCK8, cell, config, traffic, seed,
                            seconds, trace, "cpu", dtype=dtype)[0]


@pytest.mark.parametrize("name", LOOPS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] and res["failed"] == 0
    check = res["check"]
    assert check["y_err"]["value"] <= check["y_err"]["limit"]
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name", LOOPS)
def test_control_is_not_correct(name):
    _, config, _ = harness.resolve(name, MAN_BLOCK8)
    res = _run(name, dtype=config["control_dtype"])
    assert not res["correct"]
    assert res["check"]["y_err"]["value"] > res["check"]["y_err"]["limit"]


def _stale(fn):
    """A step that returns its state unchanged: every call answers the
    first call's y."""
    first = []

    def f(self, x):
        if not first:
            first.append(fn(self, x))
        return first[0].clone()
    return f


def _half(fn):
    """Half of the batch left out, the mean of the rest in its place: for
    k = 1 half of the rows, for k > 1 half of the columns."""
    def f(self, x):
        y = fn(self, x)
        if y.dim() == 1:
            y[: y.shape[0] // 2] = y[y.shape[0] // 2:].mean()
        else:
            h = y.shape[1] // 2
            y[:, :h] = y[:, h:].mean(1, keepdim=True)
        return y
    return f


def _altered(fn):
    """One answer altered where it is produced: an entry of each y."""
    gen = torch.Generator().manual_seed(0)

    def f(self, x):
        y = fn(self, x)
        i = int(torch.randint(0, y.shape[0], (1,), generator=gen))
        y[i] += 1
        return y
    return f


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", LOOPS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(TileSpMV, "forward", fault(TileSpMV.forward))
    monkeypatch.setattr(TileSpMV, "matmat", fault(TileSpMV.matmat))
    res = _run(name)
    assert not res["correct"] and res["failed"] > 0


def test_nonfinite_answer_is_not_correct(monkeypatch):
    fn, warm = TileSpMV.forward, harness.Bench.warm
    window = []

    def w(self, lp):
        warm(self, lp)
        window.append(True)

    def f(self, x):
        y = fn(self, x)
        if window:   # every call of the window
            y[0] = float("nan")
        return y
    monkeypatch.setattr(harness.Bench, "warm", w)
    monkeypatch.setattr(TileSpMV, "forward", f)
    res = _run("kron21.loop1", seconds=1.0)
    assert not res["correct"] and res["check"]["nonfinite"]["value"] > 0


@pytest.mark.parametrize("config", sorted(SMALL))
def test_control_script_readings_separate(config):
    from benchmark import control
    cfg = json.loads((harness.ROOT / f"benchmark/configs/{config}.json")
                     .read_text())
    cfg.update(SMALL[config])
    ours = control.readings(MAN, cfg, 5, 0.2, False, "cpu")
    theirs = control.readings(MAN, cfg, 5, 0.2, True, "cpu")
    assert ours["cells"] and set(ours["cells"]) == set(theirs["cells"])
    for cell, r in ours["cells"].items():
        assert r["y_err"] <= r["limit"] < theirs["cells"][cell]["y_err"]


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_its_end_to_end_metrics(name):
    res = _run(name)
    want = {m["name"] for m in harness.cell_metrics(MAN, name, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_traced_run_reads_the_glue_from_its_untraced_window():
    res = _run("kron21.loop1", seed=2 ** 31 + 5, trace=True)
    assert res["correct"]
    # on the CPU the trace holds no device operation: no roofline, no idle
    assert set(res["metrics"]) == {"plan_s", "glue_us.spmv"}
    assert res["metrics"]["glue_us.spmv"]["value"] > 0
    assert res["device"]["window_s"] > 0
    # the reservoir spans both windows' calls
    assert res["attempted"] > harness.TRACE_WARM


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_readers_of_each_kind_read_only_their_loop(kind):
    rec = harness.Record(k=1 if kind == "spmv" else 8, setup_s=1.0,
                         plan_s=0.5, iters=100, window_s=0.2, glue_s=0.01,
                         iter_ms=None, floor_ms=0.01, timeline=None)
    other = "spmm" if kind == "spmv" else "spmv"
    assert harness.plugin("metrics", f"{kind}_ms").read(rec) == \
        pytest.approx(2.0)
    assert harness.plugin("metrics", f"glue_us.{kind}").read(rec) == \
        pytest.approx(100.0)
    assert harness.plugin("metrics", f"{other}_ms").read(rec) is None
    assert harness.plugin("metrics", f"glue_us.{other}").read(rec) is None
    # without a trace: no roofline and no idle share, never a 0
    assert harness.plugin("metrics", f"{kind}_roofline").read(rec) is None
    assert harness.plugin("metrics", f"device_idle.{kind}").read(rec) is None
