"""The port's XLA-engine path (tilespmv_tpu_torch/ops/xla_spmv.py, the
plain torch engines) against tilespmv_tpu's `spmv(plan, x,
backend="xla")` / `spmm` on the identical plan (carried across by
interop.spmv_plan_from_jax), at tile sizes 1-16, and against the
float64 CSR golden; the operator's `backend=` (auto, xla, pallas).

Tolerances: f32 y within 1e-5 * max(1, max|y|) of the reference's and
rtol 2e-4 / atol 1e-4 of the golden; f64 within 1e-12 * (1 + |A|·|x|)
of both; bf16 bit-equal to the reference's y (each engine rounds where
the reference's XLA program does, ops/xla_spmv.py), and the reference's
1% + 1e-3 gate of tests/test_plan_spmv.py::test_bf16_tolerance against
the golden on its banded matrix."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops import plan as j_plan
from tilespmv_tpu.ops import spmv as j_spmv
from tilespmv_tpu_torch import TileConfig, TileSpMV, spmm, spmv
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.interop import spmv_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops import xla_spmv
from tilespmv_tpu_torch.ops.cuda import kernels
from tilespmv_tpu_torch.ops.cuda.reference import plan_array, plan_tensor
from tilespmv_tpu_torch.ops.plan import SpMVPlan, build_plan, map_plan_arrays

from test_torch_plan import assert_same
from test_torch_xla_plan import make

ARCHETYPES = ("banded", "dense_blocks", "ell", "mixed", "powerlaw",
              "uniform")
CASES = [(n, b) for n in ARCHETYPES for b in (4, 8, 12, 16)] + [
    ("mixed_64", 1), ("full_rows", 8), ("full_cols", 8), ("hyb", 12)]
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
       torch.bfloat16: jnp.bfloat16}


def plans(name, b, dtype=torch.float32, **cfg):
    """(csr, reference plan, port plan as CPU tensors) of one matrix;
    the port plan is carried across from the reference's."""
    csr = make(t_gen, name)
    cfg = dict(tile_size=b, **cfg)
    with jax.enable_x64(True):
        jplan = j_plan.build_plan(j_convert.tile_create(
            make(j_gen, name), JConfig(**cfg)), compute_dtype=JDT[dtype])
    tplan = map_plan_arrays(spmv_plan_from_jax(jplan),
                            lambda _, a: plan_tensor(a))
    return csr, jplan, tplan


def x_for(n, k=None, seed=0):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def ref_y(jplan, x, jdt=jnp.float32, mm=False):
    """The reference's xla-path y (float64 NumPy)."""
    with jax.enable_x64(True):
        f = j_spmv.spmm if mm else j_spmv.spmv
        y = f(jplan, jnp.asarray(x, jdt), backend="xla")
        return np.asarray(y.astype(jnp.float64))


def y64(t: torch.Tensor) -> np.ndarray:
    return t.double().numpy()


def golden(csr, x):
    return csr.to_dense() @ x.astype(np.float64)


def magnitude(csr, x):
    return np.abs(csr.to_dense()) @ np.abs(x.astype(np.float64))


def close32(got, ref, gold):
    err = float(np.max(np.abs(got - ref)))
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(ref)))), err
    np.testing.assert_allclose(got, gold, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("name,b", CASES)
def test_spmv_xla_matches_reference(name, b):
    csr, jplan, tplan = plans(name, b, **(
        dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
        if name == "hyb" else {}))
    x = x_for(csr.n)
    got = y64(xla_spmv.spmv_xla(tplan, torch.from_numpy(x)))
    assert got.shape == (csr.m,)
    close32(got, ref_y(jplan, x), golden(csr, x))


@pytest.mark.parametrize("name,b", [("mixed", 4), ("mixed", 8),
                                    ("powerlaw", 12), ("banded", 16),
                                    ("mixed_64", 1)])
def test_spmm_xla_matches_reference(name, b):
    """Y at k = 1, 3 and 17: all columns through each engine at once
    against the reference's vmapped SpMV, and column by column against
    the port's own SpMV."""
    csr, jplan, tplan = plans(name, b)
    for k in (1, 3, 17):
        x = x_for(csr.n, k, seed=k)
        got = y64(xla_spmv.spmm_xla(tplan, torch.from_numpy(x)))
        assert got.shape == (csr.m, k)
        close32(got, ref_y(jplan, x, mm=True), golden(csr, x))
        col = y64(xla_spmv.spmv_xla(tplan, torch.from_numpy(
            np.ascontiguousarray(x[:, k - 1]))))
        np.testing.assert_allclose(got[:, k - 1], col, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name,b", [("mixed", 8), ("powerlaw", 16),
                                    ("dense_blocks", 4), ("mixed_64", 1)])
def test_spmv_xla_f64(name, b):
    csr, jplan, tplan = plans(name, b, torch.float64)
    assert tplan.dtype == torch.float64
    x = np.random.default_rng(1).uniform(-1, 1, csr.n)
    mag = 1.0 + magnitude(csr, x)
    got = y64(xla_spmv.spmv_xla(tplan, torch.from_numpy(x)))
    assert np.max(np.abs(got - ref_y(jplan, x, jnp.float64)) / mag) <= 1e-12
    assert np.max(np.abs(got - golden(csr, x)) / mag) <= 1e-12
    xs = np.random.default_rng(2).uniform(-1, 1, (csr.n, 3))
    got = y64(xla_spmv.spmm_xla(tplan, torch.from_numpy(xs)))
    want = ref_y(jplan, xs, jnp.float64, mm=True)
    assert np.max(np.abs(got - want) / (1.0 + np.abs(csr.to_dense())
                                        @ np.abs(xs))) <= 1e-12


@pytest.mark.parametrize("name,b", [("banded", 16), ("banded", 8),
                                    ("mixed", 4), ("powerlaw", 12)])
def test_spmv_xla_bf16(name, b):
    """bf16 values, x and engines: bit-equal to the reference's y (on x
    of ones, bench.py's x and a seeded uniform x's bf16 rounding; so
    within any bound such as 2^-7 |A|·|x|), and on the banded matrices
    the reference's own gate against the golden
    (test_plan_spmv.py::test_bf16_tolerance's 1% + 1e-3, x of ones)."""
    csr, jplan, tplan = plans(name, b, torch.bfloat16)
    assert tplan.dtype == torch.bfloat16
    for x in (np.ones(csr.n, np.float32), x_for(csr.n),
              ((np.arange(csr.n) % 10) / 4.0).astype(np.float32)):
        xb = torch.from_numpy(x).to(torch.bfloat16)
        y = xla_spmv.spmv_xla(tplan, xb)
        assert y.dtype == torch.bfloat16
        got = y64(y)
        np.testing.assert_array_equal(got, ref_y(jplan, x, jnp.bfloat16))
        gold = golden(csr, xb.double().numpy())
        if x[0] == 1.0 and name == "banded":
            assert not np.any(np.abs(got - gold) > 0.01 * np.abs(gold)
                              + 1e-3)


def test_bf16_sums_miss_the_one_percent_gate_as_the_reference():
    """On a larger banded matrix (bandwidth 16, banded_large's at 1/16 of
    its rows) the reference's own bf16 gate (1% + 1e-3,
    test_plan_spmv.py:113-121) fails at tile size 8 for the reference's
    xla path, and for the port's, whose y is bit-equal to it: both add
    the engines' bf16 partials into y in bf16, each add rounded. Both
    stay within 2^-6 |A|·|x| + 1e-6 of the golden (ROADMAP.md C)."""
    n = 16384
    csr = t_gen.banded(n, n, 16, seed=8)
    with jax.enable_x64(True):
        jplan = j_plan.build_plan(j_convert.tile_create(
            j_gen.banded(n, n, 16, seed=8), JConfig(tile_size=8)),
            compute_dtype=jnp.bfloat16)
    tplan = map_plan_arrays(spmv_plan_from_jax(jplan),
                            lambda _, a: plan_tensor(a))
    x = ((np.arange(n) % 10) / 4.0).astype(np.float32)
    got = y64(xla_spmv.spmv_xla(tplan, torch.from_numpy(x)))
    want = ref_y(jplan, x, jnp.bfloat16)
    gold = golden(csr, x)
    mag = magnitude(csr, x)
    np.testing.assert_array_equal(got, want)
    for y in (got, want):
        assert np.all(np.abs(y - gold) <= 2.0 ** -6 * mag + 1e-6)
        assert np.any(np.abs(y - gold) > 0.01 * np.abs(gold) + 1e-3)


def test_padding_meets_non_finite_x_as_the_reference():
    """Padding tiles point at tile (0, 0) with zero values (ELL and CSR
    slots at column 0): an Inf in x block 0 puts NaN into the rows they
    add to, in the reference and in the port alike (ROADMAP.md C)."""
    for name, b in (("mixed", 8), ("uniform", 16), ("full_rows", 4)):
        csr, jplan, tplan = plans(name, b)
        x = x_for(csr.n)
        x[0] = np.inf
        got = y64(xla_spmv.spmv_xla(tplan, torch.from_numpy(x)))
        want = ref_y(jplan, x)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert np.isnan(want).any()
        close32(got[fin], want[fin], want[fin])


@pytest.mark.parametrize("b", [8, 16])
def test_operator_backends(b):
    """auto picks pallas exactly at tile size 16; xla runs at any tile
    size and launches no class kernel; pallas below 16 raises."""
    csr = make(t_gen, "mixed")
    cfg = TileConfig(tile_size=b)
    op = TileSpMV(csr, device="cpu", config=cfg)
    assert op.backend == ("pallas" if b == 16 else "xla")
    opx = TileSpMV(csr, device="cpu", config=cfg, backend="xla")
    assert opx.backend == "xla" and isinstance(opx.device_plan(), SpMVPlan)
    assert_same(map_plan_arrays(opx.device_plan(), lambda _, a:
                                plan_array(a)),
                build_plan(t_convert.tile_create(csr, cfg)))
    x = x_for(csr.n)
    kernels.reset_launch_counts()
    y = y64(opx(x))
    assert not any(kernels.launch_counts().values())
    np.testing.assert_allclose(y, golden(csr, x), rtol=2e-4, atol=1e-4)
    xs = x_for(csr.n, 4)
    np.testing.assert_allclose(y64(opx.matmat(xs)), golden(csr, xs),
                               rtol=2e-4, atol=1e-4)
    op16 = TileSpMV(csr, device="cpu", config=cfg, backend="xla",
                    dtype=torch.bfloat16)
    assert op16(x).dtype == torch.bfloat16
    ys16 = op16.matmat(xs)
    for r in range(4):
        assert torch.equal(ys16[:, r], op16(xs[:, r].copy()))
    np.testing.assert_array_equal(y64(opx @ x), y)
    # a TileMatrix decides by its own tile size
    tm = t_convert.tile_create(csr, cfg)
    assert TileSpMV(tm, device="cpu").backend == op.backend
    if b != 16:
        with pytest.raises(NotImplementedError, match="tile_size=16"):
            TileSpMV(csr, device="cpu", config=cfg, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        TileSpMV(csr, device="cpu", backend="mosaic")


def test_from_plan_functional_and_transpose_keep_the_backend():
    csr = make(t_gen, "mixed")
    cfg = TileConfig(tile_size=8)
    op = TileSpMV(csr, device="cpu", config=cfg, dtype=torch.float64)
    plan = op.device_plan()
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, csr.n))
    assert torch.equal(spmv(plan, x), op(x))
    xs = torch.stack([x, -x, 2 * x], dim=1)
    assert torch.equal(spmm(plan, xs), op.matmat(xs))
    host = map_plan_arrays(plan, lambda _, a: plan_array(a))
    op2 = TileSpMV.from_plan(host, device="cpu", dtype=torch.float64)
    assert op2.backend == "xla" and torch.equal(op2(x), op(x))
    with pytest.raises(ValueError, match="plan holds"):
        TileSpMV.from_plan(host, device="cpu")
    t = op.T
    assert t.backend == "xla" and t.dtype == torch.float64
    assert t.device_plan().tile_size == 8
    y = np.random.default_rng(4).uniform(-1, 1, csr.m)
    np.testing.assert_allclose(y64(op.rmatvec(y)), csr.to_dense().T @ y,
                               rtol=1e-12, atol=1e-12)
    assert op.summary["tile_size"] == 8 and op.flops() == 2 * csr.nnz
    assert op.bytes_accessed() == plan.bytes_accessed()


def test_profile_engines_refuses_xla():
    from tilespmv_tpu_torch.utils.profiling import profile_engines
    op = TileSpMV(make(t_gen, "mixed"), device="cpu", backend="xla")
    with pytest.raises(ValueError, match="pallas backend"):
        profile_engines(op)
