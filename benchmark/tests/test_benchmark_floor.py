"""The floor: the same work whatever computes it."""
import pytest

from benchmark import floor


def test_floor_of_the_cells():
    # hpcg104: 29,791,000 nonzeros, 1,124,864 rows, float64
    f = floor.floor_ms(29_791_000, 1_124_864, 1_124_864, 1, "float64")
    assert f["bytes"] == 29_791_000 * 8 + 2 * 1_124_864 * 8
    assert f["by"] == "bytes"
    assert f["ms"] == pytest.approx(0.0765, abs=5e-5)
    # kron21: about 63,540,000 nonzeros, 2,097,152 vertices, float32
    k1 = floor.floor_ms(63_540_000, 2_097_152, 2_097_152, 1, "float32")
    assert k1["ms"] == pytest.approx(0.0809, abs=5e-5)
    k8 = floor.floor_ms(63_540_000, 2_097_152, 2_097_152, 8, "float32")
    assert k8["bytes"] == 63_540_000 * 4 + 2 * 2_097_152 * 4 * 8
    assert k8["flops"] == 2 * 63_540_000 * 8
    assert k8["by"] == "bytes"
    assert k8["ms"] == pytest.approx(0.1159, abs=5e-5)


def test_floor_takes_the_larger_bound():
    # one dense row of 10**6 values against 64 columns: flops bound it
    f = floor.floor_ms(10 ** 6, 1, 10 ** 6, 64, "float64")
    t_flops = 2 * 10 ** 6 * 64 / floor.PEAK_FLOPS["float64"] * 1e3
    t_bytes = f["bytes"] / floor.HBM_BYTES_PER_S * 1e3
    assert f["ms"] == pytest.approx(max(t_flops, t_bytes))
    assert f["by"] == ("flops" if t_flops > t_bytes else "bytes")


def test_floor_counts_no_index_bytes():
    a = floor.floor_ms(1000, 10, 10, 1, "float32")
    b = floor.floor_ms(1000, 10, 10, 1, "float64")
    assert b["bytes"] == 2 * a["bytes"]
