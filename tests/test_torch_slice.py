"""The port's whole f32 slice on the CPU: TileSpMV(csr, device="cpu")
against tilespmv_tpu's spmv_pallas in interpret mode and against the
float64 CSR golden.

Tolerances: vs interpret, max |torch - jax| <= 1e-5 * max(1, max|y|)
(different f32 summation order); vs the golden, rtol 2e-4, atol 1e-4
(tests/test_pallas.py's bound)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.core.convert import tile_create as j_tile_create
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas.kernels import spmv_pallas
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan
from tilespmv_tpu_torch import TileSpMV, load_mtx
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels

CASES = {
    "mixed": ("mixed_structure", (512, 512), dict(seed=1)),
    "powerlaw": ("power_law", (512, 512, 10), dict(seed=4)),
    "ell_stream": ("ell_regular", (512, 512, 6), dict(seed=5)),
    "partial_tiles": ("mixed_structure", (1000, 777), dict(seed=11)),
    "row_windows": ("banded", (256 * 16 * 2 + 160,) * 2 + (2,),
                    dict(seed=13)),
}


def golden(csr, x):
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    return np.bincount(rows, weights=csr.data * x[csr.indices].astype(
        np.float64), minlength=csr.m)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tilespmv_cpu_matches_interpret_and_golden(name):
    fn, args, kw = CASES[name]
    csr = getattr(t_gen, fn)(*args, **kw)
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    before = kernels.launch_counts()
    op = TileSpMV(csr, device="cpu")
    y = op(x)
    assert isinstance(y, torch.Tensor) and y.shape == (csr.m,)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert kernels.launch_counts() == before   # plain versions only
    y = y.numpy()
    jplan = build_lane_plan(j_tile_create(getattr(j_gen, fn)(*args, **kw)))
    yj = np.asarray(spmv_pallas(jplan, jnp.asarray(x), interpret=True))
    err = float(np.max(np.abs(y - yj)))
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(yj)))), err
    np.testing.assert_allclose(y, golden(csr, x), rtol=2e-4, atol=1e-4)


def test_tilespmv_module_buffers_and_mtx_entry():
    csr = load_mtx("tests/fixtures/bcsstk_style_sym.mtx")
    op = TileSpMV(csr, device="cpu")
    assert op.shape == csr.shape
    names = dict(op.named_buffers())
    assert names and all(isinstance(b, torch.Tensor)
                         for b in names.values())
    # the device plan is built from the buffers, so .to() moves it
    plan = op.device_plan()
    assert plan.residual.val is names["residual_val"]
    x = np.arange(csr.n, dtype=np.float32)
    np.testing.assert_allclose(op(x).numpy(), golden(csr, x), rtol=2e-4,
                               atol=1e-4)
    with pytest.raises(ValueError):
        op(np.zeros(csr.n + 1, np.float32))
    op.to("meta")                 # buffers move with the module
    assert op.device.type == "meta"
    assert op.device_plan().residual.val.device.type == "meta"
    with pytest.raises(ValueError):
        op(x)


def test_tilespmv_residual_path():
    from tilespmv_tpu.config import TileConfig as JConfig
    from tilespmv_tpu_torch import TileConfig, tile_create
    kw = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
    csr = t_gen.power_law(512, 512, 20, seed=14)
    op = TileSpMV(tile_create(csr, TileConfig(**kw)), device="cpu")
    assert op.residual_val.numel() > 0
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    y = op(x).numpy()
    jplan = build_lane_plan(j_tile_create(
        j_gen.power_law(512, 512, 20, seed=14), JConfig(**kw)))
    yj = np.asarray(spmv_pallas(jplan, jnp.asarray(x), interpret=True))
    assert np.max(np.abs(y - yj)) <= 1e-5 * max(1.0, np.max(np.abs(yj)))
    np.testing.assert_allclose(y, golden(csr, x), rtol=2e-4, atol=1e-4)
