"""spans.py's readers: the operator-glue metrics on a hand-built
timeline (spans and runtime calls of the window only, per call; waits
and launches counted only inside `tsp.forward`), None where the program
has no spans or no phase table, and the whole set from a traced run on
the CPU."""
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark import spans as readers
from benchmark.timeline import CALL, WINDOW, Timeline

MAN = harness.manifest()
GLUE = ["prep_us.spmv", "launch_us.spmv", "finish_us.spmv",
        "call_waits.spmv", "launches.spmv"]
PLAN = ["plan_convert_s", "plan_classes_s", "plan_stream_s",
        "plan_upload_s"]


def _call(t):
    """One call at t (ns): its spans and runtime calls, 100 ns long."""
    return [(CALL, t, t + 100), ("tsp.forward", t + 2, t + 98),
            ("tsp.prep", t + 2, t + 20), ("tsp.device_plan", t + 5, t + 15),
            ("tsp.prep", t + 22, t + 40),
            ("cudaMemsetAsync", t + 30, t + 32),
            ("tsp.launch.dense", t + 40, t + 60),
            ("cudaLaunchKernel", t + 50, t + 55),
            ("tsp.launch.stream", t + 60, t + 80),
            ("cudaLaunchKernel", t + 70, t + 75),
            ("tsp.finish", t + 80, t + 95),
            ("cudaStreamSynchronize", t + 90, t + 94)]


def _timeline(events, window=(1000, 2000)):
    events = sorted(events, key=lambda e: e[1])
    calls = [e[1:] for e in events if e[0] == CALL]
    return Timeline(
        window=window, calls=np.array(calls).reshape(-1, 2),
        dev_name=[], dev=np.zeros((0, 2), np.int64),
        dev_call=np.zeros(0, bool),
        host_name=[e[0] for e in events],
        host=np.array([e[1:] for e in events], np.int64))


def _rec(tl, k=1):
    return harness.Record(k=k, setup_s=1.0, plan_s=0.5, iters=10,
                          window_s=0.1, glue_s=0.01, iter_ms=None,
                          floor_ms=0.01, timeline=tl)


def _read(name, rec):
    return harness.plugin("metrics", name).read(rec)


def _two_calls():
    # a call of the warm-up before the window (the profiler runs there
    # too, without call spans), two calls in it, and a sync between them
    warm = [e for e in _call(500) if e[0] != CALL]
    return _timeline([(WINDOW, 1000, 2000), *warm, *_call(1100),
                      *_call(1500), ("cudaStreamSynchronize", 1300, 1310),
                      ("cudaLaunchKernel", 1320, 1325)])


@pytest.mark.parametrize("name,want", [
    ("prep_us.spmv", 0.036), ("launch_us.spmv", 0.040),
    ("finish_us.spmv", 0.015), ("call_waits.spmv", 1.0),
    ("launches.spmv", 3.0)])
def test_glue_readers_on_a_timeline(name, want):
    assert _read(name, _rec(_two_calls())) == pytest.approx(want)


def test_counts_read_zero_where_nothing_ran():
    tl = _timeline([(WINDOW, 1000, 2000), (CALL, 1100, 1200),
                    ("tsp.forward", 1101, 1199)])
    for name in GLUE:
        assert _read(name, _rec(tl)) == 0.0


@pytest.mark.parametrize("case", ["untraced", "spmm", "no_spans"])
def test_glue_readers_find_nothing(case):
    tl = _two_calls()
    if case == "no_spans":
        # the program before its spans: calls and runtime calls alone
        keep = [i for i, n in enumerate(tl.host_name)
                if not n.startswith("tsp.")]
        tl.host_name = [tl.host_name[i] for i in keep]
        tl.host = tl.host[keep]
    rec = _rec(None if case == "untraced" else tl,
               k=8 if case == "spmm" else 1)
    for name in GLUE:
        assert _read(name, rec) is None


def test_plan_readers_read_the_program_table(monkeypatch):
    from tilespmv_tpu_torch import spans
    spans.reset_plan_phases()
    with spans.phase("plan.upload"):
        pass
    got = {name: _read(name, _rec(None)) for name in PLAN}
    assert got["plan_upload_s"] > 0
    assert got["plan_convert_s"] == got["plan_stream_s"] == 0.0
    # a program without the table
    monkeypatch.setitem(sys.modules, "tilespmv_tpu_torch.spans", None)
    monkeypatch.delattr("tilespmv_tpu_torch.spans")
    assert all(_read(name, _rec(None)) is None for name in PLAN)


def test_traced_cpu_run_reads_every_new_metric():
    from tilespmv_tpu_torch import spans
    cell, config, traffic = harness.resolve("kron21.loop1", MAN)
    # the smallest scale whose plan has a stream class
    config = dict(config, scale=11)
    spans.reset_plan_phases()
    res = harness.run_cell(MAN, cell, config, traffic, 2 ** 31 + 17, 0.3,
                           True, "cpu")[0]
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(GLUE + PLAN) <= set(got)
    assert all(got[n] > 0 for n in ["prep_us.spmv", "launch_us.spmv",
                                    "finish_us.spmv", "plan_convert_s",
                                    "plan_classes_s", "plan_stream_s",
                                    "plan_upload_s"])
    # no CUDA runtime on the CPU
    assert got["call_waits.spmv"] == got["launches.spmv"] == 0.0
    plan = sum(got[n] for n in PLAN)
    assert 0.9 * got["plan_s"] <= plan <= got["plan_s"]
