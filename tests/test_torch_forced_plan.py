"""The lane planner's forcing options (`force_t`, `use_stream`,
`stream_s_batch`, `stream_span_rows`, `stream_dual`, the ones the
reference's distributed layer plans shards with) against tilespmv_tpu's
build_lane_plan: each option alone and the distributed combination, in
float32, float64 and bf16, bit-equal with the native library on and off;
then the class kernels' plain versions on such plans against the Pallas
class kernels in interpret mode (the parity rules of ROADMAP.md part 1:
1e-5 * max(1, max|y|) in f32; 1e-10 * (1 + |A|·|x|) against the
reference's double-f32 arithmetic and 1e-12 against the golden in f64; bf16 y
within 2^-7 * |y_ref| + 1e-5 * max(1, max|y_ref|)), and the operator
over them against the golden."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops import spmv as j_spmv
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import reference as ref
from tilespmv_tpu_torch.ops.cuda import stream_plan as t_stream

from test_torch_plan import CASES, assert_same, make

# the options one at a time, and the distributed layer's combination
# (tilespmv_tpu/parallel/distributed.py:483-498, use_stream forced on)
OPTIONS = {
    "force_t": dict(force_t=128),
    "stream_on": dict(use_stream=True),
    "stream_off": dict(use_stream=False),
    "s_batch": dict(stream_s_batch=8),
    "span_rows": dict(stream_span_rows=64),
    "dual": dict(stream_dual=True),
    "mono": dict(stream_dual=False),
    "distributed": dict(force_t=128, use_stream=True, stream_s_batch=8,
                        stream_span_rows=64),
}
DTYPES = ((jnp.float32, np.float32), (jnp.float64, np.float64),
          (jnp.bfloat16, "bfloat16"))
# the cases whose plans hold stream classes (the native library builds
# those), run with the library on and off; the rest with it on
STREAM_CASES = ("mixed", "powerlaw", "hypersparse", "dense_blocks")


def _plans_equal(name, opts=OPTIONS):
    jtm = j_convert.tile_create(make(j_gen, name))
    ttm = t_convert.tile_create(make(t_gen, name))
    with jax.enable_x64(True):
        for oname, o in opts.items():
            for jdt, tdt in DTYPES:
                jp = j_lane.build_lane_plan(jtm, compute_dtype=jdt, **o)
                tp = t_lane.build_lane_plan(ttm, compute_dtype=tdt, **o)
                assert_same(lane_plan_from_jax(jp), tp, f"{oname} {tdt}")
                for cls in (tp.dense, *tp.sparses):
                    if cls is not None and "force_t" in o:
                        assert (cls.c_batch, cls.k_panels) == (1, 4)
                if tp.stream is not None and "stream_s_batch" in o:
                    assert (tp.stream.s_batch == o["stream_s_batch"]
                            and tp.stream2 is None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forced_lane_plan_bit_equal(name):
    _plans_equal(name)


@pytest.mark.parametrize("name", ["mixed", "powerlaw", "wide_w_class"])
def test_other_forced_values_bit_equal(name):
    """Other values of the options than the distributed layer's."""
    _plans_equal(name, {"force_t256": dict(force_t=256),
                        "force_t512": dict(force_t=512, use_stream=False),
                        "span_128": dict(stream_span_rows=128),
                        "dual_s4": dict(stream_dual=True, stream_s_batch=4)})


@pytest.mark.parametrize("name", STREAM_CASES)
def test_forced_lane_plan_bit_equal_without_native(name, monkeypatch):
    from tilespmv_tpu.core import native as j_native
    from tilespmv_tpu_torch.core import native as t_native
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    monkeypatch.setattr(t_native, "get_lib", lambda: None)
    _plans_equal(name, {k: OPTIONS[k] for k in (
        "stream_on", "s_batch", "span_rows", "dual", "distributed")})


def test_forced_shapes():
    """What each option pins: the dense chunk width; the mono non-fp
    stream layout of `stream_span_rows` alone; the free placement that
    `stream_s_batch` alone may keep; the empty class of use_stream=True
    on a matrix with no COO entries."""
    ttm = t_convert.tile_create(make(t_gen, "mixed"))
    plan = t_lane.build_lane_plan(ttm, **OPTIONS["distributed"])
    assert plan.dense.t_lanes == 128 and plan.dense.c_batch == 1
    st = plan.stream
    assert (st.s_batch, st.span_rows, st.dual, st.xmap) == (8, 64, False,
                                                             None)
    assert t_lane.build_lane_plan(ttm, force_t=256).dense.t_lanes == 256
    assert t_lane.build_lane_plan(
        ttm, stream_s_batch=8).stream.xmap is not None
    ttm = t_convert.tile_create(make(t_gen, "dense_blocks"))
    assert ttm.coo.num_tiles == 0
    for o in (dict(use_stream=True), OPTIONS["distributed"]):
        st = t_lane.build_lane_plan(ttm, **o).stream
        assert st.s_batch == o.get("stream_s_batch", 4)
        assert not np.any(st.sactive) and np.all(st.erow == -1)
        assert st.cw.shape == (1,) and not np.any(st.val)


def test_empty_stream_chunks_matches_reference():
    from tilespmv_tpu.ops.pallas import stream_plan as j_stream
    from tilespmv_tpu_torch.interop import stream_chunks_from_jax
    with jax.enable_x64(True):
        for jdt, tdt in DTYPES[:2]:
            for s in (4, 8):
                jst = j_stream.empty_stream_chunks(3, jdt, s_batch=s)
                tst = t_stream.empty_stream_chunks(3, tdt, s_batch=s)
                assert_same(stream_chunks_from_jax(jst), tst)


def test_pick_span_rows_matches_reference():
    from tilespmv_tpu.ops.pallas import stream_plan as j_stream
    rng = np.random.default_rng(7)
    for m, n, nz in ((4096, 65536, 20000), (65536, 65536, 3000),
                     (16384, 16384, 100000)):
        row = rng.integers(0, m, nz)
        col = rng.integers(0, n, nz)
        assert (t_stream.pick_span_rows(row, col, m)
                == j_stream.pick_span_rows(row, col, m))


# ----------------------------------------------------------------------
# the class kernels' plain versions on forced plans

KERNEL_CASES = {
    # dense T=128 c_batch 1 K 4, W-classes c_batch 1 K 4, one stream
    # class at S = 8, span 64, mono, not free placement
    "mixed_distributed": ("mixed", OPTIONS["distributed"]),
    "powerlaw_distributed": ("powerlaw", OPTIONS["distributed"]),
    "banded_distributed": ("banded", OPTIONS["distributed"]),
    # free placement at S = 8 (xmap), and forced into the stream
    "mixed_s_batch": ("mixed", OPTIONS["s_batch"]),
    "uniform_stream_on": ("uniform", OPTIONS["stream_on"]),
    # use_stream=True with no COO entries: the empty class
    "dense_blocks_empty": ("dense_blocks", OPTIONS["distributed"]),
    "hypersparse_dual": ("hypersparse", OPTIONS["dual"]),
}


def forced_plans(key, jdt=jnp.float32, tdt=np.float32):
    name, o = KERNEL_CASES[key]
    with jax.enable_x64(True):
        jplan = j_lane.build_lane_plan(
            j_convert.tile_create(make(j_gen, name)), compute_dtype=jdt, **o)
    tplan = t_lane.build_lane_plan(
        t_convert.tile_create(make(t_gen, name)), compute_dtype=tdt, **o)
    assert_same(lane_plan_from_jax(jplan), tplan)
    return make(t_gen, name), jplan, ref.to_torch(tplan)


def y_len(plan):
    return max(plan.y_padded_len, plan.n_stream_windows * 1024)


def x_for(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


def close(got, want):
    err = float(np.max(np.abs(got - want)))
    bound = 1e-5 * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, (err, bound)


def run_torch(fn, cls, tplan, x):
    xp = ref.pad_x(tplan, torch.from_numpy(x))
    y = torch.zeros(y_len(tplan), dtype=xp.dtype)
    fn(cls, xp, y)
    return y.numpy()


def window_flat(y2dt, length):
    flat = np.asarray(y2dt).T.reshape(-1)
    out = np.zeros(length, np.float32)
    out[: flat.size] = flat
    return out


def stream_flat(ys, nw, length):
    flat = np.asarray(ys).reshape(8, nw, 128).transpose(1, 0, 2).reshape(-1)
    out = np.zeros(length, np.float32)
    out[: flat.size] = flat
    return out


@pytest.mark.parametrize("key", sorted(KERNEL_CASES))
def test_plain_class_versions_match_interpret(key):
    """Each class of the forced f32 plan: its plain version(s) against
    the Pallas class kernel in interpret mode on the same plan."""
    csr, jplan, tplan = forced_plans(key)
    x = x_for(csr.n)
    panels = jk.x_to_panels(jplan, jnp.asarray(x))
    n = y_len(tplan)
    if tplan.dense is not None:
        if "force_t" in KERNEL_CASES[key][1]:
            assert (tplan.dense.t_lanes, tplan.dense.c_batch,
                    tplan.dense.k_panels) == (128, 1, 4)
        want = window_flat(jk.dense_class_call(
            jplan.dense, panels, jplan.n_windows, interpret=True), n)
        for fn in (ref.dense_reference, ref.dense_active_reference):
            close(run_torch(fn, tplan.dense, tplan, x), want)
    if tplan.band is not None:
        want = window_flat(jk.band_class_call(
            jplan.band, panels, jplan.n_windows, interpret=True), n)
        close(run_torch(ref.band_reference, tplan.band, tplan, x), want)
    for js, ts in zip(jplan.sparses, tplan.sparses):
        want = window_flat(jk.sparse_class_call(
            js, panels, jplan.n_windows, interpret=True), n)
        for fn in (ref.sparse_reference, ref.sparse_rows_reference):
            close(run_torch(fn, ts, tplan, x), want)
    xp128 = np.zeros(tplan.x_padded_len128, np.float32)
    xp128[: csr.n] = x
    for jst, tst in ((jplan.stream, tplan.stream),
                     (jplan.stream2, tplan.stream2)):
        if tst is None:
            continue
        nw = tplan.n_stream_windows
        want = stream_flat(jk.stream_class_call(
            jst, jnp.asarray(xp128.reshape(-1, 128)), nw, interpret=True),
            nw, n)
        for fn in (ref.stream_reference, ref.stream_rows_reference):
            close(run_torch(fn, tst, tplan, x), want)
    # the whole plan, against the golden
    y = ref.spmv_reference(tplan, torch.from_numpy(x)).double().numpy()
    np.testing.assert_allclose(y, csr.to_dense() @ x.astype(np.float64),
                               rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("key", ["mixed_distributed", "dense_blocks_empty"])
def test_forced_plan_operator_f64(key):
    """The f64 forced plan through TileSpMV.from_plan against the
    reference's operator on its df64 plan (interpret mode; double-f32
    arithmetic, so within tests/test_torch_f64_kernels.py's 1e-10) and
    within 1e-12 of the golden."""
    csr, jplan, tplan = forced_plans(key, jnp.float64, np.float64)
    op = TileSpMV.from_plan(tplan, device="cpu", dtype=torch.float64)
    x = np.random.default_rng(1).uniform(-1, 1, csr.n)
    mag = 1.0 + np.abs(csr.to_dense()) @ np.abs(x)
    got = op(x).numpy()
    with jax.enable_x64(True):
        want = np.asarray(j_spmv.TileSpMV.from_plan(
            jplan, compute_dtype=jnp.float64)(jnp.asarray(x)))
    assert np.max(np.abs(got - want) / mag) <= 1e-10
    assert np.max(np.abs(got - csr.to_dense() @ x) / mag) <= 1e-12


@pytest.mark.parametrize("key", ["mixed_distributed", "dense_blocks_empty"])
def test_forced_plan_operator_bf16(key):
    csr, jplan, tplan = forced_plans(key, jnp.bfloat16, "bfloat16")
    op = TileSpMV.from_plan(tplan, device="cpu", dtype=torch.bfloat16)
    x = x_for(csr.n)
    got = op(x).double().numpy()
    want = np.asarray(j_spmv.TileSpMV.from_plan(
        jplan, compute_dtype=jnp.bfloat16)(jnp.asarray(x, jnp.bfloat16))
        .astype(jnp.float32)).astype(np.float64)
    bound = 2.0 ** -7 * np.abs(want) + 1e-5 * max(1.0, np.max(np.abs(want)))
    assert np.all(np.abs(got - want) <= bound)


def test_forced_plan_spmm_matches_interpret():
    """The fused SpMM plain versions on the distributed f32 plan at
    k = 3 against the reference's spmm_pallas in interpret mode, and the
    golden."""
    csr, jplan, tplan = forced_plans("mixed_distributed")
    xs = np.random.default_rng(2).uniform(-1, 1, (csr.n, 3)).astype(
        np.float32)
    got = ref.spmm_reference(tplan, torch.from_numpy(xs)).numpy()
    want = np.asarray(j_spmv.TileSpMV.from_plan(jplan).matmat(
        jnp.asarray(xs)))
    close(got, want)
    np.testing.assert_allclose(got, csr.to_dense() @ xs.astype(np.float64),
                               rtol=2e-4, atol=1e-4)
