"""run.py as the driver runs it: without a card it exits 2 and prints
no result; from a folder that holds only BENCHMARK.json and the
benchmark it prints no result; on a card one short run is correct."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kron21.loop1",
         "--seed", str(2 ** 31 + 3), *args], cwd=cwd, capture_output=True,
        text=True, timeout=600)


def test_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(harness.ROOT, "--seconds", "1")
    assert res.returncode == 2 and res.stdout == ""


def test_without_the_program_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, "--seconds", "1")
    assert res.returncode != 0 and res.stdout == ""


def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(harness.ROOT, "--seconds", "1", "--trace", "1")
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert {"plan_s", "glue_us.spmv", "spmv_roofline",
            "device_idle.spmv"} <= set(out["metrics"])
    assert 0 < out["metrics"]["spmv_roofline"]["value"] <= 100
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
