"""The port's whole f64 slice on the CPU: TileSpMV(csr, device="cpu",
dtype=torch.float64) against tilespmv_tpu's TileSpMV(csr,
compute_dtype=jnp.float64) (its Pallas df64 path in interpret mode) and
against the float64 CSR golden; f64 matmat one SpMV per column; dtypes
other than float32, float64 and bfloat16 refused.

Error measure: max |y - ref| / (1 + |A|·|x|). Bounds: 1e-10 against the
reference (tests/test_dtypes.py's; its dense arm emulates double with
f32 pairs), 1e-12 against the golden (the port's plan values are the
reference's 48-bit pairs, summed in native FP64)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.io.mmio import CSRMatrix as JCSR
from tilespmv_tpu.ops.spmv import TileSpMV as JTileSpMV
from tilespmv_tpu_torch import TileSpMV, load_mtx
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.io.mmio import CSRMatrix as TCSR
from tilespmv_tpu_torch.ops.cuda import kernels, reference
from tilespmv_tpu_torch.ops.cuda.reference import class_order
from tilespmv_tpu_torch.ops.spmv import spmm, spmv

CASES = {
    "banded": ("banded", (2048, 2048, 8), dict(seed=3)),
    "powerlaw": ("power_law", (4096, 4096, 12), dict(seed=3)),
    "mixed_xmap": ("mixed_structure", (512, 512), dict(seed=7)),
    "partial_tiles": ("mixed_structure", (1000, 777), dict(seed=11)),
    "normal_values": ("mixed_structure", (1024, 1024), dict(seed=5)),
}


def make(gen, csr_cls, name):
    fn, args, kw = CASES[name]
    csr = getattr(gen, fn)(*args, **kw)
    if name == "normal_values":
        data = np.random.default_rng(0).standard_normal(csr.nnz)
        csr = csr_cls(csr.shape, csr.indptr, csr.indices, data)
    return csr


def golden_and_mag(csr, x):
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    prod = csr.data * x[csr.indices]
    return (np.bincount(rows, weights=prod, minlength=csr.m),
            np.bincount(rows, weights=np.abs(prod), minlength=csr.m))


def rel_err(y, ref, mag):
    return float(np.max(np.abs(y - ref) / (1.0 + mag)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_tilespmv_matches_reference_and_golden(name):
    csr = make(t_gen, TCSR, name)
    x = np.random.default_rng(1).standard_normal(csr.n)
    before = kernels.launch_counts()
    op = TileSpMV(csr, device="cpu", dtype=torch.float64)
    y = op(x)
    assert y.dtype == torch.float64 and y.shape == (csr.m,)
    assert kernels.launch_counts() == before    # plain versions only
    assert op.summary["dtype"] == "float64"
    assert not any(c["kind"].startswith("w") for c in op.summary["classes"])
    y = y.numpy()
    gold, mag = golden_and_mag(csr, x)
    assert rel_err(y, gold, mag) <= 1e-12
    yj = np.asarray(JTileSpMV(make(j_gen, JCSR, name),
                              compute_dtype=jnp.float64)(x))
    assert yj.dtype == np.float64
    assert rel_err(y, yj, mag) <= 1e-10


@pytest.mark.parametrize("k", [1, 3])
def test_f64_matmat_one_spmv_per_column(k):
    csr = make(t_gen, TCSR, "mixed_xmap")
    op = TileSpMV(csr, device="cpu", dtype=torch.float64)
    x = np.random.default_rng(k).uniform(-1, 1, (csr.n, k))
    before = kernels.launch_counts()
    got = op.matmat(x)
    assert got.dtype == torch.float64 and got.shape == (csr.m, k)
    assert kernels.launch_counts() == before
    for r in range(k):
        gold, mag = golden_and_mag(csr, x[:, r])
        assert rel_err(got[:, r].numpy(), gold, mag) <= 1e-12
        np.testing.assert_array_equal(got[:, r].numpy(),
                                      op(x[:, r]).numpy())
    np.testing.assert_array_equal((op @ x).numpy(), got.numpy())


def test_f64_mtx_entry_and_dtype_checks():
    csr = load_mtx("tests/fixtures/bcsstk_style_sym.mtx")
    op = TileSpMV(csr, device="cpu", dtype=torch.float64)
    x = np.linspace(-1, 1, csr.n)
    gold, mag = golden_and_mag(csr, x)
    assert rel_err(op(x).numpy(), gold, mag) <= 1e-12
    # f32 input is cast to the operator's dtype, as the reference casts
    # to compute_dtype
    assert op(x.astype(np.float32)).dtype == torch.float64
    for bad in (torch.float16, torch.int32):
        with pytest.raises(ValueError):
            TileSpMV(csr, device="cpu", dtype=bad)
    # the wrappers take x and y of the class's dtype; on CPU tensors
    # they run the plain f64 versions and launch nothing
    plan = TileSpMV(make(t_gen, TCSR, "mixed_xmap"), device="cpu",
                    dtype=torch.float64).device_plan()
    xp = reference.pad_x(plan, torch.linspace(-1, 1, plan.n,
                                              dtype=torch.float64))
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    before = kernels.launch_counts()
    for wrap, plain, cls in (
            (kernels.dense_spmv, reference.dense_reference, plan.dense),
            (kernels.stream_spmv, reference.stream_rows_reference,
             plan.stream)):
        ya = torch.zeros(ylen, dtype=torch.float64)
        yb = torch.zeros(ylen, dtype=torch.float64)
        assert wrap(cls, xp, ya) is ya
        plain(cls, xp, yb)
        assert torch.equal(ya, yb) and ya.abs().max() > 0
        with pytest.raises(TypeError):
            wrap(cls, xp.float(), torch.zeros(ylen))
    assert kernels.launch_counts() == before
    # the fused SpMM kernels take f32 and bf16 class values only: an f64
    # plan's SpMM is one SpMV per column, and no SpMM kernel is counted
    for _, kind, cls in class_order(plan):
        with pytest.raises(TypeError):
            kernels.ClassLaunch(kind, cls, xp.device, mm=True)
    X = torch.linspace(-1, 1, 2 * plan.n, dtype=torch.float64).view(-1, 2)
    before = kernels.launch_counts()
    assert torch.equal(spmm(plan, X), torch.stack(
        [spmv(plan, X[:, r]) for r in range(2)], dim=1))
    assert kernels.launch_counts() == before
