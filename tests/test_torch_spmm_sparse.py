"""The plain PyTorch W-class SpMM versions against tilespmv_tpu's fused
Pallas W-class SpMM kernel (sparse_spmm_call) in interpret mode, on the
identical plan, for k in {2, 5, 16}: sparse_spmm_reference (the rows
form, sparse_rows_reference: sparse_spmm.cu's plain version, also run by
the wrapper on CPU tensors) and sparse_reference (the Pallas kernel's
prefix form); layout and tolerance as in test_torch_spmm.py."""
import numpy as np
import pytest

from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu_torch.ops.cuda import kernels
from tilespmv_tpu_torch.ops.cuda import reference as ref
from test_torch_kernels import plans
from test_torch_spmm import KS, close_blocks, panels_k, run_torch_mm, xs_for


@pytest.mark.parametrize("k", KS)
def test_sparse_spmm_reference_matches_interpret(k):
    # a W96 class (mixed_structure(2048, 2048, seed=3): dense, W96, stream)
    jplan, tplan = plans(generate.mixed_structure(2048, 2048, seed=3))
    assert [s.width for s in tplan.sparses] == [96]
    assert ref.sparse_spmm_reference is ref.sparse_rows_reference
    x = xs_for(jplan.n, k)
    xk = panels_k(jplan, x)
    for js, ts in zip(jplan.sparses, tplan.sparses):
        want = np.asarray(jk.sparse_spmm_call(js, xk, jplan.n_windows, k,
                                              interpret=True))
        rows = run_torch_mm(ref.sparse_spmm_reference, ts, tplan, x)
        close_blocks(rows, want)
        close_blocks(run_torch_mm(ref.sparse_reference, ts, tplan, x), want)
        before = kernels.launch_counts()
        np.testing.assert_array_equal(
            run_torch_mm(kernels.sparse_spmm, ts, tplan, x), rows)
        assert kernels.launch_counts() == before
