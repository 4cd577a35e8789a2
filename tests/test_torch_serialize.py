"""Plan and tile-matrix files (tilespmv_tpu_torch/core/serialize.py)
against tilespmv_tpu.core.serialize: a TileMatrix file round-trips
bit-equal and loads in either package; a LanePlan file the port writes
(f32 or f64, NumPy or tensor arrays) round-trips bit-equal; a file the
reference writes (f32, or df64) loads equal to interop.lane_plan_from_jax
of the reference's plan; an f32 file the port writes loads in the
reference as the reference's own plan; and `TileSpMV.from_plan` on a
loaded plan gives the original operator's y. bf16 plans: the port's
file round-trips bit-exact (value arrays written as the reference
writes its own, 2-byte void items), the port loads the reference's bf16
files (whose value arrays the reference's own loader gives back as
`|V2`, not bfloat16: a fault of the reference, pinned here) as bf16
bits, and the reference loads the port's bf16 files as it loads its
own. Files of the reference planner's other arms (the offs and roll
stream scatter encodings, the prefix dense route), which the port loads
but does not build, load and run too; the committed ones under
tests/fixtures/arm_plans (which the card tests and chip_smoke.py run)
still hold what the reference writes."""
import json

import numpy as np
import pytest
import torch

from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.core import serialize as j_ser
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.io.mmio import csr_from_coo as j_csr_from_coo
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu_torch import TileSpMV, spmv_cpu
from tilespmv_tpu_torch.config import TileConfig as TConfig
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.core import serialize as t_ser
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.io.mmio import csr_from_coo as t_csr_from_coo
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda.reference import to_torch

from test_torch_plan import _skewed, assert_same, check_dense_derived, make

TM_CASES = ("mixed", "partial_tiles", "full_rows", "full_cols", "ell")
# (generator, args, kwargs, TileConfig kwargs): plans with a dense class
# and a free-placement stream (mixed), a band (banded), a stream
# (powerlaw), dense T = 256 + W24 + stream (mixed_deep), a W96 class
# (wide_w_class), a dual-span stream (hypersparse), a residual (hyb), a
# split stream pair (skewed: test_torch_plan._skewed's entries)
PLANS = {
    "mixed": ("mixed_structure", (512, 512), dict(seed=1), {}),
    "banded": ("banded", (2048, 2048, 8), dict(seed=3), {}),
    "powerlaw": ("power_law", (4096, 4096, 12), dict(seed=3), {}),
    "mixed_deep": ("mixed_structure", (4096, 4096), dict(seed=1), {}),
    "wide_w_class": ("block_random", (2048, 2048),
                     dict(density=0.05, fill=0.33, seed=5), {}),
    "hypersparse": ("hypersparse", (16384, 16384, 1e-4), dict(seed=30), {}),
    "hyb": ("power_law", (512, 512, 20), dict(seed=14),
            dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)),
    "skewed": (None, (), {}, {}),
}
PLAN_CASES = tuple(PLANS)
F64_CASES = ("mixed", "banded", "powerlaw", "mixed_deep", "skewed")
TM_FIELDS = ("tile_ptr", "tile_rowidx", "tile_columnidx", "tile_nnz", "fmt")
BUCKETS = ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol")


def _same_tm(a, b):
    assert a.shape == b.shape and a.nnz == b.nnz
    assert (a.tilem, a.tilen) == (b.tilem, b.tilen)
    for f in TM_FIELDS:
        assert_same(getattr(a, f), getattr(b, f), f)
    for bk in BUCKETS:
        assert_same(getattr(a, bk), getattr(b, bk), bk)


@pytest.mark.parametrize("name", TM_CASES)
def test_tile_matrix_round_trip_and_cross_load(name, tmp_path):
    ttm = t_convert.tile_create(make(t_gen, name),
                                TConfig(coo_nnz_threshold=10))
    jtm = j_convert.tile_create(make(j_gen, name),
                                JConfig(coo_nnz_threshold=10))
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t_ser.save_tile_matrix(pt, ttm)
    j_ser.save_tile_matrix(pj, jtm)
    back = t_ser.load_tile_matrix(pt)
    _same_tm(back, ttm)
    assert back.config == ttm.config
    _same_tm(t_ser.load_tile_matrix(pj), ttm)      # reference-written
    _same_tm(j_ser.load_tile_matrix(pt), jtm)      # read by the reference
    assert j_ser.load_tile_matrix(pt).config.coo_nnz_threshold == 10
    x = np.linspace(-1, 1, ttm.n)
    np.testing.assert_array_equal(spmv_cpu(back, x), spmv_cpu(ttm, x))


def _tm(pkg, name):
    fn, args, kw, cfg = PLANS[name]
    gen, convert, config = ((t_gen, t_convert, TConfig) if pkg == "t"
                            else (j_gen, j_convert, JConfig))
    if fn is None:
        row, col, val, m = _skewed()
        csr = (t_csr_from_coo if pkg == "t" else j_csr_from_coo)(
            m, m, row, col, val)
    else:
        csr = getattr(gen, fn)(*args, **kw)
    return convert.tile_create(csr, config(**cfg))


def _plans(name, dtype):
    with_x64 = np.dtype(dtype) == np.float64
    ttm, jtm = _tm("t", name), _tm("j", name)
    tplan = t_lane.build_lane_plan(ttm, compute_dtype=dtype)
    jplan = j_lane.build_lane_plan(jtm, compute_dtype=dtype) \
        if with_x64 else j_lane.build_lane_plan(jtm)
    return tplan, jplan


@pytest.mark.parametrize("name,dtype", [
    *((n, "float32") for n in PLAN_CASES),
    *((n, "float64") for n in F64_CASES)])
def test_port_plan_file_round_trips(name, dtype, tmp_path):
    tplan = t_lane.build_lane_plan(_tm("t", name),
                                   compute_dtype=np.dtype(dtype))
    p, pd = str(tmp_path / "plan.npz"), str(tmp_path / "dev.npz")
    t_ser.save_lane_plan(p, tplan)
    back = t_ser.load_lane_plan(p)
    assert_same(back, tplan)
    check_dense_derived(back.dense)
    # a plan of tensors (TileSpMV.device_plan) writes the same file
    t_ser.save_lane_plan(pd, to_torch(tplan))
    with np.load(p) as a, np.load(pd) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        tree = json.loads(bytes(a["__meta__"]).decode())
    assert tree["version"] == 1 and tree["tree"]["__class__"] == "LanePlan"
    assert "plan.residual.val" in a.files


@pytest.mark.parametrize("name", PLAN_CASES)
def test_reference_f32_plan_file_loads_as_carried(name, tmp_path):
    tplan, jplan = _plans(name, np.float32)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_ser.save_lane_plan(pj, jplan)
    loaded = t_ser.load_lane_plan(pj)
    assert_same(loaded, lane_plan_from_jax(jplan))
    assert_same(loaded, tplan)
    # and the reference reads the port's f32 file as its own plan
    t_ser.save_lane_plan(pt, tplan)
    assert_same(j_ser.load_lane_plan(pt, device=False),
                j_ser.load_lane_plan(pj, device=False))


@pytest.mark.parametrize("name", F64_CASES)
def test_reference_df64_plan_file_loads_as_carried(name, tmp_path):
    tplan, jplan = _plans(name, np.float64)
    pj = str(tmp_path / "j64.npz")
    j_ser.save_lane_plan(pj, jplan)
    loaded = t_ser.load_lane_plan(pj)
    assert loaded.dtype == torch.float64
    assert_same(loaded, lane_plan_from_jax(jplan))
    assert_same(loaded, tplan)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_port_bf16_plan_file_round_trips(name, tmp_path):
    tplan = t_lane.build_lane_plan(_tm("t", name), compute_dtype="bfloat16")
    p, pd = str(tmp_path / "plan.npz"), str(tmp_path / "dev.npz")
    t_ser.save_lane_plan(p, tplan)
    back = t_ser.load_lane_plan(p)
    assert back.dtype == torch.bfloat16
    assert_same(back, tplan)
    check_dense_derived(back.dense)
    t_ser.save_lane_plan(pd, to_torch(tplan))
    with np.load(p) as a, np.load(pd) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        vals = [k for k in a.files if k.endswith(".val")]
        assert vals and all(a[k].dtype == np.dtype("V2") for k in vals)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_reference_bf16_plan_file_loads_as_carried(name, tmp_path):
    import jax.numpy as jnp
    tplan = t_lane.build_lane_plan(_tm("t", name), compute_dtype="bfloat16")
    jplan = j_lane.build_lane_plan(_tm("j", name), compute_dtype=jnp.bfloat16)
    pj, pt = str(tmp_path / "j16.npz"), str(tmp_path / "t16.npz")
    j_ser.save_lane_plan(pj, jplan)
    loaded = t_ser.load_lane_plan(pj)
    assert loaded.dtype == torch.bfloat16
    assert_same(loaded, lane_plan_from_jax(jplan))
    assert_same(loaded, tplan)
    # the reference's loader gives its own bf16 values back as 2-byte
    # void items (the bytes kept, the dtype lost), and the port's file
    # the same way
    t_ser.save_lane_plan(pt, tplan)
    own = j_ser.load_lane_plan(pj, device=False)
    assert own.residual.val.dtype == np.dtype("V2")
    theirs = j_ser.load_lane_plan(pt, device=False)
    assert_same(theirs, own)
    np.testing.assert_array_equal(
        np.asarray(own.residual.val).view(np.uint16),
        np.asarray(jplan.residual.val).view(np.uint16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("name", F64_CASES)
def test_from_plan_on_loaded_plan_gives_the_same_y(name, dtype, tmp_path):
    tm = _tm("t", name)
    op = TileSpMV(tm, device="cpu", dtype=dtype)
    p = str(tmp_path / "plan.npz")
    t_ser.save_lane_plan(p, op.device_plan())
    op2 = TileSpMV.from_plan(t_ser.load_lane_plan(p), device="cpu",
                             dtype=dtype)
    assert op2.shape == op.shape and op2.nnz == op.nnz
    assert op2.summary == op.summary
    x = np.random.default_rng(1).uniform(-1, 1, tm.n)
    y, y2 = op(x), op2(x)
    assert y2.dtype == dtype
    bound = 1e-5 * max(1.0, float(y.abs().max()))
    assert float((y - y2).abs().max()) <= bound
    with pytest.raises(ValueError, match="plan holds"):
        TileSpMV.from_plan(t_ser.load_lane_plan(p), device="cpu",
                           dtype=torch.float64 if dtype == torch.float32
                           else torch.float32)


@pytest.mark.parametrize("arm", ["offs", "roll", "prefix"])
def test_reference_arm_plan_files_load_and_run(arm, tmp_path, monkeypatch):
    """A file the reference writes under STREAM_SCATTER offs or roll, or
    DENSE_ROUTE prefix (mixed_deep: a dense class, a W24 class and a
    stream), loads as interop's carry of the reference's plan, keeps its
    arm, round-trips through the port's own file, and runs through
    from_plan to the port's own plan's y."""
    from tilespmv_tpu.ops.pallas import stream_plan as j_stream
    default = TileSpMV(_tm("t", "mixed_deep"), device="cpu")
    monkeypatch.setattr(*((j_lane, "DENSE_ROUTE") if arm == "prefix"
                          else (j_stream, "STREAM_SCATTER")), arm)
    _, jplan = _plans("mixed_deep", np.float32)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_ser.save_lane_plan(pj, jplan)
    loaded = t_ser.load_lane_plan(pj)
    assert_same(loaded, lane_plan_from_jax(jplan))
    if arm == "prefix":
        assert {c.route for c in (loaded.dense, *loaded.sparses)} == {arm}
    else:
        assert loaded.stream.scatter == arm
    t_ser.save_lane_plan(pt, loaded)
    assert_same(t_ser.load_lane_plan(pt), loaded)
    op = TileSpMV.from_plan(loaded, device="cpu")
    x = np.random.default_rng(6).uniform(-1, 1, op.shape[1])
    y, want = op(x), default(x)
    assert float((y - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))


def _arm_files():
    from make_arm_plans import MANIFEST
    return json.loads(MANIFEST.read_text())


@pytest.mark.parametrize("spec", _arm_files(), ids=lambda s: s["file"])
def test_committed_arm_plan_files_are_the_references(spec):
    """Each file under tests/fixtures/arm_plans holds, array for array,
    what the reference's save_lane_plan writes for its manifest entry
    (tests/make_arm_plans.py), and loads as a plan of its arm whose y
    (through from_plan; bf16: lane_plan.as_bf16 of the f32 plan) is the
    port's own plan's: f32 and f64 within 1e-5 (f64 1e-12) of max(1,
    max|y|), bf16 against the port's bf16 operator within 2^-7 |y| +
    1e-5 max(1, max|y|), one bf16 ulp either way."""
    from make_arm_plans import FIXTURES, matrix, reference_arrays
    path = FIXTURES / spec["file"]
    want = reference_arrays(spec)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(want)
        for k in want:
            assert_same(z[k], want[k], k)
    plan = t_ser.load_lane_plan(str(path))
    if spec["arm"] == "prefix":
        assert {c.route for c in (plan.dense, *plan.sparses)} == {"prefix"}
    else:
        assert {s.scatter for s in (plan.stream, plan.stream2)
                if s is not None} == {spec["arm"]}
    csr = matrix(t_gen, spec)
    x = np.random.default_rng(8).uniform(-1, 1, csr.n)
    dtypes = ([torch.float64] if spec["dtype"] == "f64"
              else [torch.float32, torch.bfloat16])
    for dt in dtypes:
        arm_plan = t_lane.as_bf16(plan) if dt == torch.bfloat16 else plan
        y = TileSpMV.from_plan(arm_plan, device="cpu", dtype=dt)(x).double()
        want_y = TileSpMV(csr, device="cpu", dtype=dt)(x).double()
        scale = max(1.0, float(want_y.abs().max()))
        err = (y - want_y).abs()
        if dt == torch.bfloat16:
            assert bool((err <= 2 ** -7 * want_y.abs() + 1e-5 * scale).all())
        else:
            tol = 1e-12 if dt == torch.float64 else 1e-5
            assert float(err.max()) <= tol * scale, dt


def test_load_refuses_unknown_versions(tmp_path):
    tplan = t_lane.build_lane_plan(_tm("t", "mixed"))
    p = str(tmp_path / "plan.npz")
    t_ser.save_lane_plan(p, tplan)
    with np.load(p) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["version"] = 2
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(p, **arrays)
    with pytest.raises(ValueError, match="version"):
        t_ser.load_lane_plan(p)
    with pytest.raises(TypeError):
        t_ser.save_lane_plan(p, object())
