"""The rest of the port's operator API against tilespmv_tpu's TileSpMV:
`.T` (planned from the source CSR, cached, `op.T.T is op`; its plan
bit-equal to the reference's transposed plan, its y against the
reference's `.T` in interpret mode), `rmatvec`, `config=` (each forced
format and row truncation give the reference's plan bit-equal), and the
functional `spmv` / `spmm`, which `forward` and `matmat` run."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops import spmv as j_spmv
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu_torch import TileConfig, TileSpMV, spmm, spmv
from tilespmv_tpu_torch.core.convert import tile_create
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan, map_arrays
from tilespmv_tpu_torch.utils.host import csr_transpose

from test_torch_plan import assert_same, make

# tall, square with partial tiles, and square archetypes
T_CASES = ("rectangular", "partial_tiles", "mixed")


def _host_plan(op):
    """op's plan with its buffers as NumPy arrays."""
    return map_arrays(op.device_plan(), lambda _, a: a.numpy())


def _x(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


@pytest.mark.parametrize("name", T_CASES)
def test_transpose_matches_reference(name):
    csr = make(t_gen, name)
    op = TileSpMV(csr, device="cpu")
    t = op.T
    assert t.shape == (csr.n, csr.m)
    assert op.T is t and t.T is op
    assert t.device == op.device and t.dtype == op.dtype
    jop = j_spmv.TileSpMV(make(j_gen, name), backend="pallas")
    assert_same(_host_plan(t), lane_plan_from_jax(jop.T.plan))
    y = _x(csr.m, 1)
    yj = np.asarray(jop.T(jnp.asarray(y)))
    yt = t(y).numpy()
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(yt, csr.to_dense().T @ y.astype(np.float64),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(op.rmatvec(y).numpy(), yt)
    # the transpose is no submodule: the two operators refer to each
    # other without a cycle of modules
    assert list(op.children()) == [] and list(t.children()) == []
    assert len(op.state_dict()) == len(list(op.buffers()))


def test_transpose_f64_and_config_carry_over():
    csr = make(t_gen, "rectangular")
    cfg = TileConfig(force_format="csr")
    op = TileSpMV(csr, device="cpu", dtype=torch.float64, config=cfg)
    t = op.T
    assert t.dtype == torch.float64
    want = build_lane_plan(tile_create(csr_transpose(csr), cfg),
                           compute_dtype=np.float64)
    assert_same(_host_plan(t), want)
    y = np.random.default_rng(2).uniform(-1, 1, csr.m)
    np.testing.assert_allclose(t(y).numpy(), csr.to_dense().T @ y,
                               rtol=1e-12, atol=1e-12)


def test_transpose_needs_the_source_csr():
    csr = make(t_gen, "mixed")
    with pytest.raises(ValueError, match="source CSRMatrix"):
        TileSpMV(tile_create(csr), device="cpu").T
    op = TileSpMV(csr, device="cpu")
    with pytest.raises(ValueError, match="source CSRMatrix"):
        TileSpMV.from_plan(_host_plan(op), device="cpu").rmatvec(
            np.zeros(csr.m))


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "dns", "truncate"])
def test_config_plans_match_reference(fmt):
    kw = (dict(truncate_rows_to_tile=True) if fmt == "truncate"
          else dict(force_format=fmt))
    name = "partial_tiles"
    op = TileSpMV(make(t_gen, name), device="cpu", config=TileConfig(**kw))
    jplan = j_lane.build_lane_plan(j_convert.tile_create(make(j_gen, name),
                                                         JConfig(**kw)))
    assert_same(_host_plan(op), lane_plan_from_jax(jplan))
    if fmt == "truncate":
        assert op.shape[0] == (make(t_gen, name).m // 16) * 16
    x = _x(op.shape[1])
    np.testing.assert_allclose(op(x).numpy(), np.asarray(
        j_spmv.TileSpMV.from_plan(jplan)(jnp.asarray(x))),
        rtol=2e-4, atol=1e-4)


def test_tile_size_other_than_16_is_not_ported():
    with pytest.raises(NotImplementedError, match="tile_size=16"):
        TileSpMV(make(t_gen, "mixed"), device="cpu",
                 config=TileConfig(tile_size=8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_functional_spmv_spmm_are_the_operators_path(dtype):
    csr = make(t_gen, "mixed")
    op = TileSpMV(csr, device="cpu", dtype=dtype)
    plan = op.device_plan()
    x = torch.from_numpy(_x(csr.n)).to(dtype)
    assert torch.equal(spmv(plan, x), op(x))
    for k in (1, 4, 17):
        xs = torch.from_numpy(np.stack([_x(csr.n, r) for r in range(k)],
                                       axis=1)).to(dtype)
        assert torch.equal(spmm(plan, xs), op.matmat(xs))
        assert torch.equal(spmm(plan, xs)[:, 0], op(xs[:, 0].contiguous()))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        spmv(plan, x.to("meta"))
