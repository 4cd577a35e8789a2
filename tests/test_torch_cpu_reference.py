"""The port's tile-by-tile CPU engine (tilespmv_tpu_torch/ops/
cpu_reference.py) against tilespmv_tpu's: `spmv_cpu` y bit-equal on
every tests/test_torch_plan.py archetype (tile COO or the residual), on
a HYB-converted matrix with the residual, and `plan_chunks` equal; it is
also the CSR golden's exact match (the CLI's errcount)."""
import numpy as np
import pytest

from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops import cpu_reference as j_cpu
from tilespmv_tpu_torch import spmv_cpu
from tilespmv_tpu_torch.config import TileConfig as TConfig
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cpu_reference import plan_chunks

from test_torch_plan import CASES, make


def _x(n):
    return np.random.default_rng(0).uniform(-1, 1, n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_cpu_bit_equal_to_reference(name):
    jtm = j_convert.tile_create(make(j_gen, name))
    ttm = t_convert.tile_create(make(t_gen, name))
    x = _x(ttm.n)
    for kw in (dict(), dict(include_coo_tiles=False,
                            include_residual=True)):
        yt, yj = spmv_cpu(ttm, x, **kw), j_cpu.spmv_cpu(jtm, x, **kw)
        assert yt.dtype == yj.dtype
        np.testing.assert_array_equal(yt, yj)
    # dyadic x: main.cu's exact-equality count is 0
    csr = make(t_gen, name)
    xd = (np.arange(csr.n) % 10) / 4.0
    np.testing.assert_array_equal(spmv_cpu(ttm, xd), csr.matvec(xd))
    for a, b in zip(plan_chunks(ttm), j_cpu.plan_chunks(jtm)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_spmv_cpu_hyb_with_residual_bit_equal():
    # HYB on: its overflow entries are in the residual, not in the tiles
    kw = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
    jtm = j_convert.tile_create(j_gen.power_law(512, 512, 20, seed=14),
                                JConfig(**kw))
    ttm = t_convert.tile_create(t_gen.power_law(512, 512, 20, seed=14),
                                TConfig(**kw))
    assert ttm.hyb.num_tiles and ttm.hyb.coo_val.size
    x = _x(512)
    yt = spmv_cpu(ttm, x, include_coo_tiles=False, include_residual=True)
    np.testing.assert_array_equal(
        yt, j_cpu.spmv_cpu(jtm, x, include_coo_tiles=False,
                           include_residual=True))
    np.testing.assert_allclose(yt, t_gen.power_law(512, 512, 20, seed=14)
                               .matvec(x), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        spmv_cpu(ttm, x[:-1])
