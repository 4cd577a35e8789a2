"""StreamChunks.erow, the per-entry output rows that the H100 stream
kernel reads (stream_plan.entry_rows), against the round planes they are
derived from: every slot with a nonzero value has exactly one row in
[0, 1024), the row q*128 + j of the one run of lanes (rstart, rend] of
sublane rsrc[q, j] that covers it in some round; rows never fall along a
sublane's entries; lane 0 and padding hold EROW_PAD. For the port's
builders (mono, dual, free placement, the split pair) and for plans
carried across from tilespmv_tpu, which hold the same rows, in f32 and
f64."""
import jax.numpy as jnp
import numpy as np
import pytest

from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.ops.pallas import stream_plan as j_stream
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.interop import (lane_plan_from_jax,
                                        stream_chunks_from_jax)
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import stream_plan as t_stream

from test_torch_plan import _entries, _skewed

LANES = np.arange(128)


def check_rows(st) -> None:
    erow = np.asarray(st.erow)
    val = np.asarray(st.val)
    nsl = val.shape[0]
    assert erow.dtype == np.int16 and erow.shape == val.shape == (nsl, 8,
                                                                  128)
    real = erow != t_stream.EROW_PAD
    assert ((erow[real] >= 0) & (erow[real] < 1024)).all()
    assert not real[:, :, 0].any()
    assert real[val != 0].all() and (val[~real] == 0).all()
    r = erow.astype(np.int64)
    both = real[:, :, 1:] & real[:, :, :-1]
    assert (np.diff(r, axis=2)[both] >= 0).all()
    # every run of the planes, lane by lane
    S, R = st.s_batch, st.rounds
    p = np.asarray(st.planes).astype(np.int64).reshape(
        -1, R, 3, S, 8, 128).transpose(0, 3, 1, 2, 4, 5).reshape(
        nsl, R, 3, 8, 128)
    covered = 0
    for t in range(R):
        rend, rstart, rsrc = p[:, t, 0], p[:, t, 1], p[:, t, 2]
        for q in range(8):
            src = rsrc[:, q]                                 # (nsl, j)
            e = np.take_along_axis(rend, src[:, None], 1)[:, 0]
            s = np.take_along_axis(rstart, src[:, None], 1)[:, 0]
            sl, j = np.nonzero(e > s)
            lanes = (LANES > s[sl, j, None]) & (LANES <= e[sl, j, None])
            rows = r[sl, src[sl, j]]                         # (runs, 128)
            assert (rows[lanes] == np.broadcast_to(
                (q * 128 + j)[:, None], lanes.shape)[lanes]).all()
            covered += int(lanes.sum())
    assert covered == int(real.sum())


# (entries, port builder kwargs); None: the two halves of a split class
CASES = {
    "mono": (lambda: _entries(1, 4096, 4096, 30000, heavy_rows=3),
             dict(span_rows=64, dual=False)),
    "dual": (lambda: _entries(11, 16384, 16384, 100_000),
             dict(span_rows=64, dual=True)),
    "free_placement": (lambda: _entries(4, 65536, 65536, 4000),
                       dict(fp=True)),
    "split_mono": (_skewed, dict(dual=False)),
    "split_dual": (_skewed, dict(dual=True)),
}
DTYPES = {"f32": (np.float32, jnp.float32), "f64": (np.float64, jnp.float64)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_rows_follow_the_planes(case, dtype):
    make, kw = CASES[case]
    t_dt, j_dt = DTYPES[dtype]
    row, col, val, m = make()
    if case.startswith("split"):
        ours = t_stream.build_stream_classes(
            row, col, val, m, span_rows=64, compute_dtype=t_dt, **kw)
        (jb, jh), _ = j_stream.build_stream_classes(
            row, col, val, m, span_rows=64, compute_dtype=j_dt, **kw)
        theirs = (jb, jh)
        assert ours[1] is not None
    else:
        ours = (t_stream.build_stream_chunks(row, col, val, m,
                                             compute_dtype=t_dt, **kw),)
        theirs = (j_stream.build_stream_chunks(row, col, val, m,
                                               compute_dtype=j_dt,
                                               **kw)[0],)
    if case == "free_placement":
        assert ours[0].xmap is not None
    for st, jst in zip(ours, theirs):
        check_rows(st)
        carried = stream_chunks_from_jax(jst)
        check_rows(carried)
        np.testing.assert_array_equal(carried.erow, st.erow)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_entry_rows_of_a_lane_plan_with_xmap(dtype):
    """mixed_structure(512, 512, seed=1): build_lane_plan's stream class
    is a free-placement one; the carried JAX plan holds the same rows."""
    t_dt, j_dt = DTYPES[dtype]
    tplan = t_lane.build_lane_plan(t_convert.tile_create(
        t_gen.mixed_structure(512, 512, seed=1)), compute_dtype=t_dt)
    jplan = lane_plan_from_jax(j_lane.build_lane_plan(j_convert.tile_create(
        j_gen.mixed_structure(512, 512, seed=1)), compute_dtype=j_dt))
    assert tplan.stream.xmap is not None
    for st in (tplan.stream, jplan.stream):
        check_rows(st)
    np.testing.assert_array_equal(tplan.stream.erow, jplan.stream.erow)
