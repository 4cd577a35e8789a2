"""metrics/state_builds.py: the program's count of call states in a
run, None from a program without the counter or without the module."""
import sys

from benchmark import harness

MAN = harness.manifest()


def _read(rec):
    return harness.plugin("metrics", "state_builds").read(rec)


def test_state_builds_reads_the_program_counter(monkeypatch):
    """One call state in a traced CPU run of a cell (its operator's)."""
    from tilespmv_tpu_torch import spans
    cell, config, traffic = harness.resolve("kron21.loop1", MAN)
    spans.reset_state_builds()
    res = harness.run_cell(MAN, cell, dict(config, scale=11), traffic,
                           2 ** 33 + 5, 0.2, True, "cpu")[0]
    assert res["correct"]
    assert res["metrics"]["state_builds"]["value"] == 1
    assert _read(None) == 1
    monkeypatch.delattr(spans, "state_builds")
    assert _read(None) is None
    monkeypatch.setitem(sys.modules, "tilespmv_tpu_torch.spans", None)
    monkeypatch.delattr("tilespmv_tpu_torch.spans")
    assert _read(None) is None
