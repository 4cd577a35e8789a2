"""BENCHMARK.json: names, units, files and bounds as the contract has
them, and every name found by the harness."""
import json
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_and_names():
    assert set(MAN) == KEYS["top"]
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert 1 <= len(MAN[kind])
        for e in MAN[kind]:
            extra = {"workloads"} if kind in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "source", "layer"):
                if key in e:
                    assert TEXT.match(e[key]), e[key]
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in MAN[kind]}) == len(MAN[kind])
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(MAN)) < 64 * 1024


def test_units_and_sources():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_command_paths_and_budget():
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    r = MAN["run_seconds"]
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


def test_every_name_has_its_file():
    root = harness.ROOT
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        # reduced lists exactly the keys the file says it changed
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])
        assert (harness.HERE / "generators"
                / f"{cfg['generator']}.py").exists()
        assert cfg["dtype"] in harness.DTYPES
        assert cfg["control_dtype"] in harness.DTYPES
        assert cfg["limits"]["y_err"] > 0
    for w in MAN["workloads"]:
        cell, cfg, traffic = harness.resolve(w["name"], MAN)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert {"k", "check_every", "solve_len", "samples"} <= set(traffic)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        mod = harness.plugin("metrics", m["name"])
        assert callable(mod.read)


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in MAN["per_layer"]:
        # each cell that reports it reports the metric it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    for w in cells:
        ends = [m["name"] for m in harness.cell_metrics(MAN, w,
                                                        "end_to_end")]
        assert "setup_s" in ends and len(ends) >= 2
        assert harness.cell_metrics(MAN, w, "per_layer")


# the layers of PERF.md's list, each named alike by all its metrics
LAYERS = {"host planning", "operator glue", "class kernels", "device"}


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_layers_are_named_alike(name):
    m = next(p for p in MAN["per_layer"] if p["name"] == name)
    assert m["layer"] in LAYERS
