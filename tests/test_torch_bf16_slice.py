"""The port's bf16 slice on the CPU against tilespmv_tpu's bf16 path (its
Pallas kernels in interpret mode, as its own tests run them).

Per class: each plain PyTorch class version on a bf16 plan (the plain
versions of the eight `*_bf16` kernels) against the reference's Pallas
class kernel on the identical plan (lane_plan_from_jax), x and X rounded
to bf16 and widened to float32 as both packages widen them, for SpMV and
for SpMM at k in {2, 5, 16}. Then the operator: TileSpMV(csr,
dtype=torch.bfloat16, device="cpu") against the reference's
TileSpMV(csr, compute_dtype=jnp.bfloat16), `matmat` against its
`matmat` and `.T` against its `.T`, and everything against the float64
golden.

Bounds:
* the generator's values (quarters) and a dyadic x (quarters): every
  product and every float32 sum is exact, so the class outputs and y
  are bit-equal to the reference's;
* a standard-normal x: the class outputs (float32, before any rounding
  to bf16) within 1e-5 * max(1, max|y_ref|), the float32 sum order; y
  (rounded to bf16 once) within 2^-7 * |y_ref| + 1e-5 * max(1,
  max|y_ref|): one bf16 ulp either way from the order of the sums (the
  residual's products are exact in float32 on both sides: the residual
  test below);
* against the float64 golden: |y - golden| <= 2^-6 * (|A|·|x|) + 1e-6
  (bf16's unit roundoff is 2^-8: the values' and x's rounding, 2^-8
  each of each product, and y's, 2^-8 of |y|).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core.convert import tile_create as j_tile_create
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan
from tilespmv_tpu.ops.spmv import TileSpMV as JTileSpMV
from tilespmv_tpu_torch import TileConfig, TileSpMV, tile_create
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels
from tilespmv_tpu_torch.ops.cuda import reference as ref
from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan as t_build

BF = jnp.bfloat16
TOL = 1e-5
HYB = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
# name -> (generator call, TileConfig kwargs): the plans' classes
MATRICES = {
    "band": (("banded", (2048, 2048, 8), dict(seed=3)), {}),
    "mixed": (("mixed_structure", (512, 512), dict(seed=1)), {}),
    "w16": (("random_uniform", (512, 512, 0.003), dict(seed=3)), {}),
    "w96": (("block_random", (2048, 2048),
             dict(density=0.05, fill=0.33, seed=5)), {}),
    "stream": (("power_law", (4096, 4096, 12), dict(seed=3)), {}),
    "hyb_residual": (("power_law", (512, 512, 20), dict(seed=14)), HYB),
}


def csr_of(gen, name):
    (fn, args, kw), _ = MATRICES[name]
    return getattr(gen, fn)(*args, **kw)


def plans(name):
    cfg = MATRICES[name][1]
    jplan = build_lane_plan(j_tile_create(csr_of(j_gen, name),
                                          JConfig(**cfg)),
                            compute_dtype=BF)
    tplan = ref.to_torch(lane_plan_from_jax(jplan))
    assert tplan.dtype == torch.bfloat16
    return jplan, tplan


def bf16(x) -> np.ndarray:
    """x rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(x, BF).astype(jnp.float32))


def x_of(kind, shape, seed=0):
    """bf16-exact float32 x: "dyadic" (quarters, bench.py's pattern
    shifted per column) or "normal" (standard normal, rounded)."""
    if kind == "dyadic":
        i = np.arange(shape[0]).reshape((-1,) + (1,) * (len(shape) - 1))
        if len(shape) > 1:
            i = i + np.arange(shape[1])
        return ((i % 10) / 4.0).astype(np.float32)
    return bf16(np.random.default_rng(seed).standard_normal(shape))


def y_len(plan):
    return max(plan.y_padded_len, plan.n_stream_windows * 1024)


def check(got, want, kind):
    """Bit-equal for dyadic x; else within TOL * max(1, max|want|)."""
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        err = float(np.max(np.abs(got - want)))
        assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err


def window_flat(y2dt, length):
    """(16, n_windows*256) class output -> flat y rows (float32)."""
    flat = np.asarray(y2dt, np.float32).T.reshape(-1)
    out = np.zeros(length, np.float32)
    out[: flat.size] = flat
    return out


def stream_rows(yj, length):
    """(8, nw*128) stream class output -> flat y rows (float32)."""
    nw = yj.shape[1] // 128
    flat = np.asarray(yj, np.float32).reshape(8, nw, 128).transpose(
        1, 0, 2).reshape(-1)
    out = np.zeros(length, np.float32)
    out[: flat.size] = flat
    return out


def run_torch(fn, cls, tplan, x):
    """The plain version into a zeroed f32 y; x (n,) or (n, k)."""
    xp = ref.pad_x(tplan, torch.from_numpy(x).to(torch.bfloat16))
    assert xp.dtype == torch.float32
    y = torch.zeros((y_len(tplan),) + x.shape[1:])
    assert fn(cls, xp, y) is y
    return y.numpy()


def x128(jplan, x):
    """x (n,) as the stream kernels' (rows, 128) bf16 layout."""
    xp = jnp.zeros(jplan.x_padded_len128, BF).at[: jplan.n].set(
        jnp.asarray(x, BF))
    return xp.reshape(-1, 128)


# (class kind, matrix): every class of a bf16 plan, its plain versions
SPMV_CASES = [("band", "band"), ("dense", "mixed"), ("sparse", "w16"),
              ("sparse", "w96"), ("stream", "stream"), ("stream", "mixed")]


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("cls_kind,name", SPMV_CASES)
def test_bf16_class_matches_interpret(cls_kind, name, kind):
    jplan, tplan = plans(name)
    x = x_of(kind, (jplan.n,))
    n = y_len(tplan)
    if cls_kind == "stream":
        st = [c for c in (tplan.stream, tplan.stream2) if c is not None]
        js = [c for c in (jplan.stream, jplan.stream2) if c is not None]
        assert st and all(c.val.dtype == torch.bfloat16 for c in st)
        nw = jplan.n_stream_windows
        for jc, tc in zip(js, st):
            want = stream_rows(jk.stream_class_call(
                jc, x128(jplan, x), nw, interpret=True), n)
            check(run_torch(ref.stream_rows_reference, tc, tplan, x), want,
                  kind)
        return
    panels = jk.x_to_panels(jplan, jnp.asarray(x, BF))
    if cls_kind == "sparse":
        assert tplan.sparses
        for js, ts in zip(jplan.sparses, tplan.sparses):
            assert ts.val.dtype == torch.bfloat16
            want = window_flat(jk.sparse_class_call(
                js, panels, jplan.n_windows, interpret=True), n)
            check(run_torch(ref.sparse_rows_reference, ts, tplan, x), want,
                  kind)
        return
    call = {"band": jk.band_class_call, "dense": jk.dense_class_call}
    jc, tc = getattr(jplan, cls_kind), getattr(tplan, cls_kind)
    assert tc is not None and tc.val.dtype == torch.bfloat16
    want = window_flat(call[cls_kind](jc, panels, jplan.n_windows,
                                      interpret=True), n)
    plain = {"band": (ref.band_reference,),
             "dense": (ref.dense_reference, ref.dense_active_reference)}
    for fn in plain[cls_kind]:
        check(run_torch(fn, tc, tplan, x), want, kind)


def panels_k(jplan, x):
    """spmm_pallas's bf16 x panels: the k RHS stacked along the lanes."""
    return jnp.concatenate([jk.x_to_panels(jplan, jnp.asarray(x[:, r], BF))
                            for r in range(x.shape[1])], axis=2)


def blocks_flat(blocks, length, k):
    """A Pallas SpMM output (k*16, nw*256) as (length, k) y rows."""
    return np.stack([window_flat(blocks[16 * r: 16 * r + 16], length)
                     for r in range(k)], axis=1)


@pytest.mark.parametrize("k", [2, 5, 16])
@pytest.mark.parametrize("cls_kind,name", [
    ("band", "band"), ("dense", "mixed"), ("sparse", "w16"),
    ("stream", "mixed")])
def test_bf16_spmm_class_matches_interpret(cls_kind, name, k):
    """The SpMM plain versions over X (n, k) against the reference's
    fused SpMM calls (the stream class an RHS pair a call, an odd k's
    last column by its SpMV call), with a standard-normal X."""
    jplan, tplan = plans(name)
    x = x_of("normal", (jplan.n, k), seed=k)
    n = y_len(tplan)
    if cls_kind == "stream":
        nw = jplan.n_stream_windows
        want = np.zeros((n, k), np.float32)
        for r in range(0, k - 1, 2):
            pair = jk.stream_class_call2(jplan.stream, x128(jplan, x[:, r]),
                                         x128(jplan, x[:, r + 1]), nw,
                                         interpret=True)
            want[:, r], want[:, r + 1] = (stream_rows(p, n) for p in pair)
        if k % 2:
            want[:, k - 1] = stream_rows(jk.stream_class_call(
                jplan.stream, x128(jplan, x[:, k - 1]), nw, interpret=True),
                n)
        check(run_torch(ref.stream_rows_reference, tplan.stream, tplan, x),
              want, "normal")
        return
    call = {"band": jk.band_spmm_call, "dense": jk.dense_spmm_call,
            "sparse": jk.sparse_spmm_call}[cls_kind]
    jc = jplan.sparses[0] if cls_kind == "sparse" else getattr(jplan,
                                                               cls_kind)
    tc = tplan.sparses[0] if cls_kind == "sparse" else getattr(tplan,
                                                               cls_kind)
    want = blocks_flat(np.asarray(call(jc, panels_k(jplan, x),
                                       jplan.n_windows, k, interpret=True)),
                       n, k)
    plain = {"band": ref.band_spmm_reference,
             "dense": ref.dense_spmm_reference,
             "sparse": ref.sparse_spmm_reference}[cls_kind]
    check(run_torch(plain, tc, tplan, x), want, "normal")


def golden_and_mag(csr, x):
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    prod = csr.data * x[csr.indices].astype(np.float64)
    return (np.bincount(rows, weights=prod, minlength=csr.m),
            np.bincount(rows, weights=np.abs(prod), minlength=csr.m))


def check_y(y, yj, kind):
    """y against the reference's y: bit-equal for dyadic x, else within
    2^-7 * |y_ref| + TOL * max(1, max|y_ref|)."""
    y, yj = (np.asarray(a, np.float64) for a in (y, yj))
    if kind == "dyadic":
        np.testing.assert_array_equal(y, yj)
    else:
        bound = 2.0 ** -7 * np.abs(yj) + TOL * max(1.0, np.abs(yj).max())
        assert np.all(np.abs(y - yj) <= bound), np.max(np.abs(y - yj))


def check_golden(csr, y, x):
    gold, mag = golden_and_mag(csr, x)
    assert np.all(np.abs(np.asarray(y, np.float64) - gold)
                  <= 2.0 ** -6 * mag + 1e-6)


def y_np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.bfloat16
    return t.float().numpy()


OP_CASES = ["band", "mixed", "w96", "stream", "hyb_residual"]


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("name", OP_CASES)
def test_bf16_tilespmv_matches_reference(name, kind):
    csr = csr_of(t_gen, name)
    cfg = MATRICES[name][1]
    x = x_of(kind, (csr.n,), seed=1)
    before = kernels.launch_counts()
    op = TileSpMV(tile_create(csr, TileConfig(**cfg)), device="cpu",
                  dtype=torch.bfloat16)
    y = op(x)
    assert y.shape == (csr.m,) and op.summary["dtype"] == "bfloat16"
    assert kernels.launch_counts() == before       # plain versions only
    assert op.device_plan().dtype == torch.bfloat16
    jop = JTileSpMV(j_tile_create(csr_of(j_gen, name), JConfig(**cfg)),
                    compute_dtype=BF)
    yj = jop(x)
    assert yj.dtype == BF
    check_y(y_np(y), np.asarray(yj.astype(jnp.float32)), kind)
    check_golden(csr, y_np(y), x)
    if name == "hyb_residual":
        assert op.device_plan().residual.val.shape[0] > 0


def test_bf16_residual_product_rounding():
    """The residual adds each product, exact in float32, into the f32 y,
    as the reference's `plan.residual.val * x[col]` runs jitted: XLA's
    excess precision keeps that bf16 product in float32 (op by op, JAX
    rounds it to bf16 instead)."""
    a = 1.0078125                        # 1 + 2^-7: a bf16
    val = jnp.asarray([a, 3.0], BF)
    x = jnp.asarray([a, a], BF)
    exact = [a * a, 3 * a]               # not bf16 values
    np.testing.assert_array_equal(
        np.asarray((val * x).astype(jnp.float32)),
        [1.015625, 3.03125])             # op by op: rounded to bf16
    jitted = jax.jit(lambda y, v, u: y.at[jnp.arange(2)].add(v * u))
    np.testing.assert_array_equal(np.asarray(jitted(
        jnp.zeros(2, jnp.float32), val, x)), exact)
    _, tplan = plans("hyb_residual")
    res = dataclasses.replace(
        tplan.residual, val=torch.tensor([a, 3.0], dtype=torch.bfloat16),
        row=torch.tensor([0, 1]), col=torch.tensor([0, 1]))
    y = torch.zeros(4)
    ref.residual_add(dataclasses.replace(tplan, residual=res),
                     torch.tensor([a, a], dtype=torch.bfloat16), y)
    np.testing.assert_array_equal(y.numpy(), exact + [0, 0])


@pytest.mark.parametrize("k", [2, 5, 16])
def test_bf16_matmat_matches_reference(k):
    """matmat through the fused SpMM plain versions (dense and a
    free-placement stream class) against the reference's spmm_pallas in
    interpret mode: bit-equal with a dyadic X."""
    csr = csr_of(t_gen, "mixed")
    op = TileSpMV(csr, device="cpu", dtype=torch.bfloat16)
    x = x_of("dyadic", (csr.n, k))
    before = kernels.launch_counts()
    y = op.matmat(x)
    assert y.shape == (csr.m, k) and kernels.launch_counts() == before
    assert torch.equal(op @ x, y)
    yj = JTileSpMV(csr_of(j_gen, "mixed"), compute_dtype=BF).matmat(x)
    check_y(y_np(y), np.asarray(yj.astype(jnp.float32)), "dyadic")
    for r in range(k):
        check_golden(csr, y_np(y)[:, r], x[:, r])


def test_bf16_matmat_with_a_residual():
    """matmat on a plan with dense, W16 and residual entries (HYB
    overflow) at k = 2: bit-equal to the reference's with a dyadic X."""
    csr = csr_of(t_gen, "hyb_residual")
    op = TileSpMV(tile_create(csr, TileConfig(**HYB)), device="cpu",
                  dtype=torch.bfloat16)
    assert op.device_plan().residual.val.shape[0] > 0
    x = x_of("dyadic", (csr.n, 2))
    y = y_np(op.matmat(x))
    yj = JTileSpMV(j_tile_create(csr_of(j_gen, "hyb_residual"),
                                 JConfig(**HYB)), compute_dtype=BF).matmat(x)
    check_y(y, np.asarray(yj.astype(jnp.float32)), "dyadic")
    for r in range(2):
        check_golden(csr, y[:, r], x[:, r])


def test_bf16_matmat_normal_x_and_k17():
    """A standard-normal X at k = 3 against the reference (within the
    y bound) and the golden; k = 17 runs one bf16 SpMV per column."""
    csr = csr_of(t_gen, "band")
    op = TileSpMV(csr, device="cpu", dtype=torch.bfloat16)
    x = x_of("normal", (csr.n, 3), seed=4)
    y = y_np(op.matmat(x))
    yj = JTileSpMV(csr_of(j_gen, "band"), compute_dtype=BF).matmat(x)
    assert op.device_plan().residual.val.shape[0] == 0
    check_y(y, np.asarray(yj.astype(jnp.float32)), "normal")
    for r in range(3):
        check_golden(csr, y[:, r], x[:, r])
    x17 = x_of("dyadic", (csr.n, 17))
    y17 = op.matmat(x17)
    for r in (0, 16):
        assert torch.equal(y17[:, r], op(x17[:, r].copy()))


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
def test_bf16_transpose_matches_reference(kind):
    csr = t_gen.rectangular(2048, 256, 8, seed=23)
    op = TileSpMV(csr, device="cpu", dtype=torch.bfloat16)
    x = x_of(kind, (csr.m,), seed=2)
    z = op.T(x)
    assert z.shape == (csr.n,) and op.T.dtype == torch.bfloat16
    assert torch.equal(op.rmatvec(x), z) and op.T.T is op
    jop = JTileSpMV(j_gen.rectangular(2048, 256, 8, seed=23),
                    compute_dtype=BF)
    check_y(y_np(z), np.asarray(jop.T(x).astype(jnp.float32)), kind)


def test_bf16_x_rounding_and_dtypes():
    """x is rounded to bf16 first, as the reference casts it to its
    compute dtype; the wrappers take f32 x and y for bf16 classes and
    refuse bf16 ones; an f32 plan is no bf16 operator."""
    csr = csr_of(t_gen, "mixed")
    op = TileSpMV(csr, device="cpu", dtype=torch.bfloat16)
    x = np.random.default_rng(5).standard_normal(csr.n)
    assert torch.equal(op(x), op(bf16(x)))
    plan = op.device_plan()
    xp = ref.pad_x(plan, torch.from_numpy(bf16(x)))
    ylen = y_len(plan)
    before = kernels.launch_counts()
    for wrap, plain, cls in (
            (kernels.dense_spmv, ref.dense_reference, plan.dense),
            (kernels.stream_spmv, ref.stream_rows_reference, plan.stream)):
        ya, yb = torch.zeros(ylen), torch.zeros(ylen)
        assert wrap(cls, xp, ya) is ya
        plain(cls, xp, yb)
        assert torch.equal(ya, yb) and ya.abs().max() > 0
        with pytest.raises(TypeError):
            wrap(cls, xp.bfloat16(), torch.zeros(ylen, dtype=torch.bfloat16))
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="plan holds"):
        TileSpMV.from_plan(t_build(tile_create(csr)), device="cpu",
                           dtype=torch.bfloat16)
    p16 = TileSpMV.from_plan(t_build(tile_create(csr),
                                     compute_dtype="bfloat16"),
                             device="cpu", dtype=torch.bfloat16)
    assert torch.equal(p16(x), op(x))
