"""The port's examples (tilespmv_tpu_torch/examples) on the CPU: the
bounds of tests/test_examples.py, and the same solution as the JAX
examples (examples/cg.py, examples/pagerank.py, examples/
distributed_run.py) on the same system."""
import pathlib
import sys

import numpy as np
import torch

import jax.numpy as jnp
from tilespmv_tpu.ops.spmv import TileSpMV as JTileSpMV
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.examples import cg, distributed_run, pagerank

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from examples import cg as j_cg  # noqa: E402
from examples import pagerank as j_pagerank  # noqa: E402


def test_cg_example():
    assert cg.main(device="cpu") < 1e-4
    csr = cg.make_spd()
    x_true = np.random.default_rng(0).standard_normal(csr.n)
    b = csr.matvec(x_true.astype(np.float32).astype(np.float64))
    x, _ = cg.cg(TileSpMV(csr, device="cpu"),
                 torch.as_tensor(b, dtype=torch.float32))
    xj, _ = j_cg.cg(JTileSpMV(j_cg.make_spd()),
                    jnp.asarray(b, dtype=jnp.float32))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-4)


def test_pagerank_example():
    assert pagerank.main(device="cpu") < 1e-6
    g = pagerank.generate.power_law(4096, 4096, avg_nnz_per_row=12, seed=7)
    r = pagerank.pagerank(TileSpMV(pagerank.column_stochastic(g),
                                   device="cpu")).numpy()
    gj = j_pagerank.generate.power_law(4096, 4096, avg_nnz_per_row=12,
                                       seed=7)
    rj = np.asarray(j_pagerank.pagerank(JTileSpMV(
        j_pagerank.column_stochastic(gj))))
    # ranks are ~1/n: held relative to them
    np.testing.assert_allclose(r, rj, rtol=1e-4, atol=1e-7)


def test_distributed_example():
    """distributed_run on eight virtual CPU devices (one sweep point):
    the 1-D and 2-D operators within test_halo_exchange_banded's 1e-4 of
    the golden; the 1-D operator's y within 1e-5 * max(1, max|y|) of the
    reference example's (auto: halo on banded_medium, 8 devices)."""
    from tilespmv_tpu.io import generate as j_gen
    from tilespmv_tpu.parallel import DistributedSpMV as JDist
    from tilespmv_tpu.parallel import make_mesh as j_make_mesh
    from tilespmv_tpu_torch.io import generate
    from tilespmv_tpu_torch.parallel import DistributedSpMV, make_mesh
    assert distributed_run.main(quick=True, device="cpu") < 1e-4
    csr = generate.get_matrix("banded_medium")
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    op = DistributedSpMV(csr, mesh=make_mesh(8, devices=["cpu"] * 8),
                         x_mode="auto")
    jop = JDist(j_gen.get_matrix("banded_medium"), mesh=j_make_mesh(8),
                x_mode="auto")
    assert op.x_mode == jop.x_mode == "halo"
    want = np.asarray(jop(x))
    assert np.max(np.abs(op(x).numpy() - want)) <= 1e-5 * max(
        1.0, float(np.max(np.abs(want))))
