"""timeline.py: busy time, the calls' device time, and the breakdown."""
import numpy as np
import pytest
import torch

from benchmark.timeline import CALL, WINDOW, Timeline


def _tl():
    return Timeline(
        window=(0, 100),
        calls=np.array([[10, 20], [50, 60]]),
        dev_name=["k_a", "k_b", "k_a", "fill"],
        dev=np.array([[12, 30], [30, 35], [55, 58], [70, 80]]),
        dev_call=np.array([True, True, True, False]),
        host_name=[WINDOW, CALL, "cudaLaunchKernel", CALL, "aten::item",
                   "cudaStreamSynchronize"],
        host=np.array([[0, 100], [10, 20], [11, 13], [50, 60], [85, 99],
                       [86, 98]]))


def test_busy_and_window():
    tl = _tl()
    merged, busy = tl.busy()
    assert merged.tolist() == [[12, 35], [55, 58], [70, 80]]
    assert busy == pytest.approx(36e-9)
    assert tl.window_s() == pytest.approx(100e-9)
    assert tl.call_device_s() == pytest.approx(26e-9)


def test_breakdown():
    tl = _tl()
    assert tl.top_device_ops() == [["k_a", pytest.approx(21e-9)],
                                   ["fill", pytest.approx(10e-9)],
                                   ["k_b", pytest.approx(5e-9)]]
    gaps = dict((k, v) for k, v in tl.idle_gaps())
    # 0-12 (mid 6: the window), 35-55 (mid 45: the window), 58-70 (mid
    # 64: the window), 80-100 (mid 90: the innermost, the sync)
    assert gaps == {WINDOW: pytest.approx(44e-9),
                    "cudaStreamSynchronize": pytest.approx(20e-9)}


def test_from_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for _ in range(3):
                with record_function(CALL):
                    torch.ones(4).sum()
    tl = Timeline.from_profile(prof)
    assert len(tl.calls) == 3 and tl.window_s() > 0
    assert tl.busy()[1] == 0 and tl.top_device_ops() == []
    assert np.all(np.diff(tl.host[:, 0]) >= 0)


def test_no_window_raises():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    with pytest.raises(RuntimeError):
        Timeline.from_profile(prof)
