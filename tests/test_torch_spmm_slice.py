"""The port's SpMM slice on the CPU: TileSpMV(csr, device="cpu").matmat
and `@` against tilespmv_tpu's `spmm` with the Pallas backend (which runs
spmm_pallas in interpret mode for 2 <= k <= 16 and the vmapped
interpret-mode SpMV otherwise, tilespmv_tpu/ops/spmv.py:69-89) and
against the float64 CSR golden, for k in {1, 2, 5, 16, 17}; no kernel
launches on the CPU.

Tolerances: vs interpret, max |torch - jax| <= 1e-5 * max(1, max|Y|)
(different f32 summation order); vs the golden, rtol 2e-4, atol 1e-4
(tests/test_pallas.py's bound)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core.convert import tile_create as j_tile_create
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan
from tilespmv_tpu.ops.spmv import spmm
from tilespmv_tpu_torch import TileConfig, TileSpMV, tile_create
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels

HYB = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
# name -> (generator, args, TileConfig kwargs, k values). Plans: mixed
# has dense + a free-placement stream class, ell_stream a stream class
# only (k = 16 interprets fastest there: 8 stream pairs), band the band
# class, hyb_residual dense + W16 + a residual.
CASES = {
    "mixed": ("mixed_structure", (512, 512), {}, (1, 2, 5, 17)),
    "ell_stream": ("ell_regular", (512, 512, 6), {}, (16,)),
    "band": ("banded", (512, 512, 10), {}, (5,)),
    "hyb_residual": ("power_law", (512, 512, 20), HYB, (2,)),
}
SEEDS = {"mixed": 1, "ell_stream": 5, "band": 5, "hyb_residual": 14}


def golden_mm(csr, x):
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    return np.stack([np.bincount(rows, weights=csr.data * x[csr.indices, r]
                                 .astype(np.float64), minlength=csr.m)
                     for r in range(x.shape[1])], axis=1)


@pytest.mark.parametrize("name,k", [(n, k) for n, c in sorted(CASES.items())
                                    for k in c[3]])
def test_matmat_cpu_matches_interpret_and_golden(name, k):
    fn, args, cfg, _ = CASES[name]
    seed = SEEDS[name]
    csr = getattr(t_gen, fn)(*args, seed=seed)
    x = np.random.default_rng(k).uniform(-1, 1, (csr.n, k)).astype(
        np.float32)
    before = kernels.launch_counts()
    op = TileSpMV(tile_create(csr, TileConfig(**cfg)), device="cpu")
    y = op.matmat(x)
    assert isinstance(y, torch.Tensor) and y.shape == (csr.m, k)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert torch.equal(op @ x, y)
    assert kernels.launch_counts() == before   # plain versions only
    y = y.numpy()
    jplan = build_lane_plan(j_tile_create(
        getattr(j_gen, fn)(*args, seed=seed), JConfig(**cfg)))
    yj = np.asarray(spmm(jplan, jnp.asarray(x), backend="pallas"))
    err = float(np.max(np.abs(y - yj)))
    assert err <= 1e-5 * max(1.0, float(np.max(np.abs(yj)))), err
    np.testing.assert_allclose(y, golden_mm(csr, x), rtol=2e-4, atol=1e-4)


def test_matmul_ranks_and_plan_counts():
    csr = t_gen.mixed_structure(512, 512, seed=1)
    op = TileSpMV(csr, device="cpu")
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    assert torch.equal(op @ x, op(x))
    with pytest.raises(ValueError):
        op @ np.zeros((csr.n, 2, 2), np.float32)
    with pytest.raises(ValueError):
        op.matmat(np.zeros((csr.n + 1, 2), np.float32))
    with pytest.raises(ValueError):
        op.matmat(x)
    jplan = build_lane_plan(j_tile_create(j_gen.mixed_structure(
        512, 512, seed=1)))
    assert op.flops() == jplan.flops() == 2 * csr.nnz
    assert op.bytes_accessed() == jplan.bytes_accessed()
