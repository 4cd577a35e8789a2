"""The port's 1-D operator in f64 and bf16 against the reference's on
the same seeded inputs (the reference on its 8 virtual CPU devices, the
port on devices=["cpu"] * 8).

Tolerances, with |A|·|x| the product of the magnitudes row by row:
- f64: max |y - y_ref| / (1 + |A|·|x|) <= 1e-10 (the reference's
  double-f32 arithmetic, tests/test_torch_f64_kernels.py's bound), and
  <= 1e-12 against the float64 golden;
- bf16: |y - y_ref| <= 2^-8 · |A|·|x| + 1e-6 element by element (each
  y is rounded to bf16 once per plan; in halo mode the local and the
  foreign y are added in bf16 by both packages). On this input it comes
  out bit-equal, and the test says so."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tilespmv_tpu.parallel import DistributedSpMV as JDist
from tilespmv_tpu.parallel import make_mesh as j_make_mesh
from tilespmv_tpu_torch.parallel import DistributedSpMV, make_mesh

from test_torch_distributed import CPU8, make
from test_torch_distributed_y import golden


def magnitude(csr, x) -> np.ndarray:
    """|A|·|x| row by row."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    return np.bincount(rows, weights=np.abs(csr.data * x[csr.indices]),
                       minlength=csr.m)


@pytest.mark.parametrize("x_mode", ["allgather", "halo"])
def test_f64_matches_reference(x_mode):
    jc, tc = make("mixed")
    x = np.random.default_rng(5).uniform(-1, 1, tc.n)
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=x_mode,
                         dtype=torch.float64)
    y = op(x)
    assert y.dtype == torch.float64
    y = y.numpy()
    with jax.enable_x64(True):
        jy = np.asarray(JDist(jc, mesh=j_make_mesh(8), x_mode=x_mode,
                              compute_dtype=jnp.float64)(x))
    mag = 1.0 + magnitude(tc, x)
    assert np.max(np.abs(y - jy) / mag) <= 1e-10
    assert np.max(np.abs(y - golden(tc, x)) / mag) <= 1e-12


@pytest.mark.parametrize("x_mode", ["allgather", "halo"])
def test_bf16_matches_reference(x_mode):
    jc, tc = make("mixed")
    x = np.linspace(-1, 1, tc.n).astype(np.float32)
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=x_mode,
                         dtype=torch.bfloat16)
    y = op(x)
    assert y.dtype == torch.bfloat16
    y = y.double().numpy()
    jy = np.asarray(JDist(jc, mesh=j_make_mesh(8), x_mode=x_mode,
                          compute_dtype=jnp.bfloat16)(x)).astype(np.float64)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float64)
    assert np.all(np.abs(y - jy) <= 2.0 ** -8 * magnitude(tc, xb) + 1e-6)
    # bit-equal on this input
    np.testing.assert_array_equal(y, jy)
