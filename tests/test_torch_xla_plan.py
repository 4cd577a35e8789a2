"""The port's XLA-engine plan (tilespmv_tpu_torch/ops/plan.py::build_plan)
against tilespmv_tpu's: the tile matrices and the plans are bit-equal
(dtype, shape, values) at tile sizes 4, 8, 12 and 16 (and 1 on a 64 x 64
matrix), in float32, float64 and bf16 (the port's uint16 bits against
the reference's NumPy bfloat16), with HYB tiles enabled and with each
forced format, on tests/test_plan_spmv.py's archetypes and its
single-format matrices."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops import plan as j_plan
from tilespmv_tpu_torch.config import TileConfig
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.interop import spmv_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops import plan as t_plan
from tilespmv_tpu_torch.ops.cuda.stream_plan import BF16_BITS

from test_torch_plan import assert_same

# tests/test_plan_spmv.py's archetypes (:30-37) and single-format
# matrices (:50-60), by generator call and seed
MATRICES = {
    "mixed": ("mixed_structure", (512, 512), dict(seed=1)),
    "banded": ("banded", (1024, 1024, 8), dict(seed=2)),
    "uniform": ("random_uniform", (1024, 1024, 0.002), dict(seed=3)),
    "powerlaw": ("power_law", (1024, 1024, 12), dict(seed=4)),
    "ell": ("ell_regular", (1024, 1024, 7), dict(seed=5)),
    "dense_blocks": ("dense_blocks", (512, 512), dict(num_blocks=128,
                                                      seed=6)),
    "dense_only": ("dense_blocks", (256, 256), dict(num_blocks=64, seed=1)),
    "full_rows": ("full_rows", (256, 256), dict(num_rows=5, seed=2)),
    "full_cols": ("full_cols", (256, 256), dict(num_cols=5, seed=3)),
    "ell_only": ("ell_regular", (256, 256, 4), dict(seed=4)),
    "coo_only": ("random_uniform", (256, 256, 0.002), dict(seed=5)),
    # tile size 1: a 64 x 64 matrix
    "mixed_64": ("mixed_structure", (64, 64), dict(seed=1)),
    # test_plan_spmv.py's HYB matrix (:63-67)
    "hyb": ("power_law", (256, 256, 20), dict(seed=6)),
}
DTYPES = ((jnp.float32, np.float32), (jnp.float64, np.float64),
          (jnp.bfloat16, "bfloat16"))
# the tile matrix's arrays and buckets that must agree
TM_ARRAYS = ("tile_ptr", "tile_rowidx", "tile_columnidx", "tile_nnz", "fmt")
TM_BUCKETS = ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol")


def make(gen, name):
    fn, args, kw = MATRICES[name]
    return getattr(gen, fn)(*args, **kw)


def tile_pair(name, **cfg):
    """(reference TileMatrix, port TileMatrix), checked bit-equal."""
    jtm = j_convert.tile_create(make(j_gen, name), JConfig(**cfg))
    ttm = t_convert.tile_create(make(t_gen, name), TileConfig(**cfg))
    for f in TM_ARRAYS:
        np.testing.assert_array_equal(getattr(ttm, f), getattr(jtm, f),
                                      err_msg=f)
    for bucket in TM_BUCKETS:
        assert_same(getattr(jtm, bucket), getattr(ttm, bucket), bucket)
    return jtm, ttm


def check_plans(jtm, ttm):
    """build_plan both ways in every dtype, bit-equal; returns the f32
    port plan."""
    with jax.enable_x64(True):
        for jdt, tdt in DTYPES:
            jp = j_plan.build_plan(jtm, compute_dtype=jdt)
            tp = t_plan.build_plan(ttm, compute_dtype=tdt)
            assert_same(tp, spmv_plan_from_jax(jp))
            if tdt == "bfloat16":
                assert tp.dense.val.dtype == BF16_BITS
            assert tp.bytes_accessed() == jp.bytes_accessed()
            assert (tp.x_padded_len, tp.y_padded_len) == (
                jp.x_padded_len, jp.y_padded_len)
            assert tp.flops() == jp.flops()
    return t_plan.build_plan(ttm)


CASES = [(n, b) for n in sorted(MATRICES) if n not in ("mixed_64", "hyb")
         for b in (4, 8, 12, 16)] + [("mixed_64", 1)]


@pytest.mark.parametrize("name,b", CASES)
def test_build_plan_bit_equal(name, b):
    jtm, ttm = tile_pair(name, tile_size=b)
    plan = check_plans(jtm, ttm)
    assert plan.tile_size == b
    for e in plan.ells:
        assert e.val.shape == e.col.shape
    for e in plan.csrs:
        assert e.val.shape == e.rowcol.shape and e.val.shape[0] % 8 == 0


@pytest.mark.parametrize("b", [8, 12, 16])
def test_build_plan_hyb(b):
    """HYB tiles: their ELL parts join the ELL engines, their overflow
    the residual (plan.py:268-277)."""
    jtm, ttm = tile_pair("hyb", tile_size=b, enable_hyb=True,
                         hyb_cv_threshold=0.3, hyb_max_coo=64)
    assert ttm.hyb.num_tiles > 0
    plan = check_plans(jtm, ttm)
    assert plan.ells


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "dns"])
@pytest.mark.parametrize("b", [8, 16])
def test_build_plan_forced_format(fmt, b):
    jtm, ttm = tile_pair("mixed", tile_size=b, force_format=fmt)
    check_plans(jtm, ttm)


def test_build_plan_rejects_other_dtypes():
    ttm = t_convert.tile_create(make(t_gen, "mixed"))
    with pytest.raises(ValueError, match="compute_dtype"):
        t_plan.build_plan(ttm, compute_dtype=np.float16)


def test_map_plan_arrays_names_every_array():
    """Every engine array gets a unique identifier, in ells and csrs
    too, and the walk keeps the static fields."""
    plan = t_plan.build_plan(t_convert.tile_create(
        make(t_gen, "mixed"), TileConfig(tile_size=8)))
    arrays = {}
    skel = t_plan.map_plan_arrays(
        plan, lambda n, a: arrays.setdefault(n, a) is a and n)
    assert all(n.isidentifier() for n in arrays)
    assert len(arrays) == 3 * 3 + 4 * (len(plan.ells) + len(plan.csrs)) + 3
    assert skel.tile_size == 8 and skel.csrs[0].val == "csr0_val"
    assert_same(t_plan.map_plan_arrays(skel, lambda n, _: arrays[n]), plan)
