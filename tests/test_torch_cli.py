"""The port's command-line tool (tilespmv_tpu_torch/cli.py) on the CPU
(`-d cpu`): the .mtx check (errcount 0, PASS), plan and tile-matrix
files, the plan cache, the manifest sweep and --resume
(tests/test_aux.py's), the options the port does not serve yet (exit
2), and no silent CPU fallback without a card."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tilespmv_tpu_torch import cli

FIX = "tests/fixtures/nist_example.mtx"
QUICK = ["--iters", "2", "--reps", "1", "--warmup", "1"]


def test_mtx_on_the_cpu(tmp_path, capsys):
    csvp = tmp_path / "results.csv"
    rc = cli.main(["-d", "cpu", FIX, "--csv", str(csvp), "--profile",
                   "--iters", "2", "--reps", "3", "--warmup", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "CPU TileSpMV errcount = 0" in out
    assert "Check... PASS!" in out
    assert "plan summary: " in out and "per-format-class cost" in out
    assert "TileSpMV: " in out and "of cpu HBM roofline" in out
    assert "eager " in out and "spread " in out
    rows = csvp.read_text().splitlines() if csvp.exists() else []
    assert all(r.startswith(f"{FIX},5,5,8,") for r in rows)


def test_result_line_units():
    from tilespmv_tpu_torch.bench.harness import BenchResult
    # 8e6 nonzeros in 0.02 ms: 400 Gnnz/s, that is 400 Mnnz/ms
    res = BenchResult(name="m", m=1, n=1, nnz=8_000_000, ms=0.02,
                      gflops=800.0, gnnz_per_s=400.0, gbytes_per_s=1000.0,
                      roofline_frac=0.3, chip="h100_sxm", backend="cuda",
                      iters=10, spread=0.012, eager_ms=0.1)
    assert cli._bench_line(res) == (
        "TileSpMV: 0.0200 ms, 800.00 GFLOPS, 400.00 Mnnz/ms, 1000.0 GB/s "
        "(30.0% of h100_sxm HBM roofline); eager 0.1000 ms, spread 1.2%")


def test_save_and_load_plan_and_tiles(tmp_path, capsys):
    plan, tiles = str(tmp_path / "p.npz"), str(tmp_path / "t.npz")
    assert cli.main(["-d", "cpu", "mixed_small", "--save-plan", plan,
                     "--save-tiles", tiles, "--csv", ""] + QUICK) == 0
    out = capsys.readouterr().out
    assert "errcount = 0" in out and "PASS!" in out
    assert f"plan saved to {plan}" in out
    assert cli.main(["-d", "cpu", "--load-plan", plan, "mixed_small",
                     "--csv", ""] + QUICK) == 0
    out = capsys.readouterr().out
    assert "plan loaded in" in out and "m=256 n=256" in out
    assert "Check... PASS!" in out and "TileSpMV: " in out
    assert cli.main(["-d", "cpu", "mixed_small", "--load-tiles", tiles,
                     "--dtype", "f64", "--csv", ""] + QUICK) == 0
    out = capsys.readouterr().out
    assert "errcount = 0" in out and "PASS!" in out and "dtype=f64" in out
    # an f32 plan file is not an f64 operator
    with pytest.raises(ValueError, match="plan holds"):
        cli.main(["-d", "cpu", "--load-plan", plan, "--dtype", "f64",
                  "--csv", ""] + QUICK)


def test_sweep_manifest(tmp_path, capsys):
    """--sweep-manifest over a fixtures-scale manifest: manifest parse ->
    UFget layout resolve -> load -> convert -> bench (reference
    bench0.sh:1-14)."""
    root = tmp_path / "corpus"
    (root / "HB" / "nist").mkdir(parents=True)
    shutil.copy(FIX, root / "HB" / "nist" / "nist.mtx")
    # fallback layout: <name>.mtx directly under the root
    shutil.copy(FIX, root / "flat.mtx")
    man = tmp_path / "man.csv"
    man.write_text("1,HB,nist,5,5,8\n2,HB,flat,5,5,8\n3,HB,absent,5,5,8\n")
    rc = cli.main(["-d", "cpu", "--sweep-manifest", str(man),
                   "--matrix-dir", str(root), "--csv", ""] + QUICK)
    out = capsys.readouterr().out
    assert rc == 0
    assert "sweeping 2 manifest matrices (1 not fetched)" in out
    assert "2/2 ok" in out
    empty = tmp_path / "empty.csv"
    empty.write_text("1,HB,absent,5,5,8\n")
    assert cli.main(["-d", "cpu", "--sweep-manifest", str(empty),
                     "--matrix-dir", str(root)]) == 2


def test_sweep_resume_skips_recorded_rows(tmp_path, capsys):
    """--resume: matrices whose name already has a results.csv row are
    skipped; --plan-cache writes each plan on first visit and reads it
    on the next."""
    root = tmp_path / "corpus"
    root.mkdir()
    shutil.copy(FIX, root / "a.mtx")
    shutil.copy(FIX, root / "b.mtx")
    csvp = tmp_path / "results.csv"
    csvp.write_text("a.mtx,5,5,8,0.001000,0.0160\n")  # prior-run row
    cache = tmp_path / "cache"
    args = ["-d", "cpu", "--sweep-dir", str(root), "--resume",
            "--plan-cache", str(cache), "--csv", str(csvp)] + QUICK
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "resumed: 1 matrices already in" in out
    assert "a.mtx: ms=" not in out      # skipped, not re-timed
    assert "b.mtx: ms=" in out          # the new row still runs
    names = [ln.split(",", 1)[0]
             for ln in csvp.read_text().splitlines() if ln]
    assert names.count("a.mtx") == 1
    assert sorted(os.listdir(cache)) == ["b.mtx.f32.plan.npz"]
    # from the cache: the same sweep without --resume
    assert cli.main(["-d", "cpu", "--sweep-dir", str(root), "--plan-cache",
                     str(cache), "--csv", ""] + QUICK) == 0
    assert "2/2 ok" in capsys.readouterr().out


@pytest.mark.parametrize("args,item", [
    (["--scaling"], "A.12"),
    (["--dtype", "bf16", FIX], "A.14"),
    (["--tile-size", "8", FIX], "A.13")])
def test_unported_options_exit_2(args, item, capsys):
    assert cli.main(["-d", "cpu"] + args) == 2
    assert f"ROADMAP.md {item}" in capsys.readouterr().err


def test_no_card_no_fallback(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([FIX]) == 2
    assert "-d cpu" in capsys.readouterr().err
    assert cli.main(["-d", "cpu"]) == 2          # no matrix given


def test_module_entry_point():
    res = subprocess.run(
        [sys.executable, "-m", "tilespmv_tpu_torch.cli", "-d", "cpu", FIX,
         "--csv", ""] + QUICK, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "errcount = 0" in res.stdout and "PASS!" in res.stdout
