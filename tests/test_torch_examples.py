"""The port's examples (tilespmv_tpu_torch/examples) on the CPU: the
bounds of tests/test_examples.py, and the same solution as the JAX
examples (examples/cg.py, examples/pagerank.py) on the same system."""
import pathlib
import sys

import numpy as np
import torch

import jax.numpy as jnp
from tilespmv_tpu.ops.spmv import TileSpMV as JTileSpMV
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.examples import cg, pagerank

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
