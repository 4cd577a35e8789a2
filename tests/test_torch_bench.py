"""The port's bench harness, roofline table and sweep
(tilespmv_tpu_torch/bench) against tilespmv_tpu.bench: the card is told
apart by its name, results.csv rows have the reference's schema,
unreliable rows are refused, a CPU benchmark gives finite times, its
bytes are the classes' bound, and profiling's H100 figures are the
roofline table's."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from tilespmv_tpu.bench import harness as j_harness
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.bench import harness, roofline
from tilespmv_tpu_torch.bench.sweep import sweep
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.utils import profiling


@pytest.mark.parametrize("name,chip", [
    ("NVIDIA H100 80GB HBM3", "h100_sxm"),
    ("NVIDIA H100 SXM5 80GB", "h100_sxm"),
    ("NVIDIA H100 PCIe", "h100_pcie"),
    ("NVIDIA H100 NVL", "h100_nvl"),
    ("NVIDIA A100-SXM4-80GB", roofline.UNKNOWN),
    (None, "cpu")])
def test_detect_chip(name, chip, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: name is not None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: name)
    assert roofline.detect_chip() == chip
    if chip == roofline.UNKNOWN:
        assert math.isnan(roofline.peak_bandwidth_gbps())
    else:
        assert roofline.peak_bandwidth_gbps() == roofline.HBM_GBPS[chip]
        assert roofline.peak_compute_gflops(vbytes=8) == \
            roofline.PEAK_GFLOPS[chip][8]


def test_profiling_reads_the_sxm_figures():
    assert profiling.HBM_BYTES_PER_S == 3.35e12
    assert profiling.PEAK_FLOPS == {4: 67e12, 8: 34e12}
    assert roofline.roofline_gflops(2, 4, "h100_sxm") == pytest.approx(
        2 / (4 / 3.35e12) / 1e9)


def _fields(**kw):
    base = dict(name="a.mtx", m=5, n=7, nnz=8, ms=0.0123456789,
                gflops=1.23456789, gnnz_per_s=0.5, gbytes_per_s=3.0,
                roofline_frac=0.1, chip="h100_sxm", backend="cuda",
                iters=10, reliable=True, spread=0.01)
    base.update(kw)
    return base


def test_csv_row_has_the_reference_schema(tmp_path):
    mine = harness.BenchResult(**_fields(), eager_ms=0.2)
    ref = j_harness.BenchResult(**_fields())
    assert mine.csv_row() == ref.csv_row()
    assert [f.name for f in dataclasses.fields(mine)][:-1] == \
        [f.name for f in dataclasses.fields(ref)]
    p = tmp_path / "results.csv"
    harness.append_results_csv(str(p), mine)
    assert p.read_text() == ref.csv_row() + "\n"
    with pytest.raises(ValueError, match="unreliable"):
        harness.append_results_csv(
            str(p), harness.BenchResult(**_fields(reliable=False)))
    assert p.read_text().count("\n") == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_benchmark_op_on_the_cpu(dtype):
    csr = generate.mixed_structure(512, 512, seed=1)
    op = TileSpMV(csr, device="cpu", dtype=dtype)
    res = harness.benchmark_op(op, name="mixed", warmup=1, timed_reps=3,
                               iters_per_rep=2)
    assert res.chip == "cpu" and res.backend == "cpu"
    assert (res.m, res.n, res.nnz) == (512, 512, csr.nnz)
    assert np.isfinite(res.ms) and res.ms > 0 and res.eager_ms == res.ms
    assert res.gflops == pytest.approx(2 * csr.nnz / res.ms / 1e6)
    assert res.iters == 6 and res.spread >= 0
    plan = op.device_plan()
    classes = [c for c in (plan.dense, plan.band, *plan.sparses,
                           plan.stream, plan.stream2) if c is not None]
    nbytes = profiling.class_bound(classes)["bytes"]
    assert res.gbytes_per_s == pytest.approx(nbytes / res.ms / 1e6)
    assert res.roofline_frac == pytest.approx(res.gbytes_per_s / 50.0)
    # the plan's own byte count includes arrays no kernel reads
    assert nbytes < op.bytes_accessed()


def test_sweep_on_the_cpu(tmp_path, capsys):
    csvp, jsonp = tmp_path / "r.csv", tmp_path / "r.json"
    res = sweep(["mixed_small"], device="cpu", csv_path=str(csvp),
                json_path=str(jsonp), iters_per_rep=2, timed_reps=3,
                warmup=1, max_spread=math.inf)
    assert len(res) == 1 and res[0].reliable
    assert csvp.read_text() == res[0].csv_row() + "\n"
    assert '"eager_ms"' in jsonp.read_text()
    assert "mixed_small: m=256" in capsys.readouterr().out
