"""The CUDA class kernels against their plain PyTorch versions on the
card. Marked `cuda`: skipped where there is no GPU. Imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-5 * max(1, max|plain|) — the
order of float32 atomic adds varies from run to run."""
import numpy as np
import pytest
import torch

from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops.cuda import kernels, reference

pytestmark = pytest.mark.cuda

MATRICES = {
    "band": lambda: generate.get_matrix("banded_medium"),
    "dense_sparse_stream": lambda: generate.get_matrix("mixed_medium"),
    "stream_dual": lambda: generate.hypersparse(65536, 65536, 1e-4, seed=3),
    "stream_fp": lambda: generate.mixed_structure(512, 512, seed=1),
    "w96": lambda: generate.block_random(2048, 2048, density=0.05,
                                         fill=0.33, seed=5),
}
PAIRS = {"band": (kernels.band_spmv, reference.band_reference),
         "dense": (kernels.dense_spmv, reference.dense_reference),
         "sparse": (kernels.sparse_spmv, reference.sparse_reference),
         "stream": (kernels.stream_spmv, reference.stream_reference)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernels_match_plain_versions(name, device):
    csr = MATRICES[name]()
    op = TileSpMV(csr, device=device)
    plan = op.device_plan()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, csr.n).astype(np.float32)).to(device)
    xp = reference.pad_x(plan, x)
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    classes = {"band": [plan.band], "dense": [plan.dense],
               "sparse": list(plan.sparses),
               "stream": [plan.stream, plan.stream2]}
    ran = 0
    for kind, cls_list in classes.items():
        for cls in cls_list:
            if cls is None:
                continue
            wrap, plain = PAIRS[kind]
            yk = torch.zeros(ylen, device=device)
            yp = torch.zeros(ylen, device=device)
            before = kernels.launch_counts()[kind]
            wrap(cls, xp, yk)
            assert kernels.launch_counts()[kind] == before + 1
            plain(cls, xp, yp)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            assert err <= 1e-5 * max(1.0, float(yp.abs().max())), kind
            ran += 1
    assert ran
    # end to end vs the float64 golden with bench.py's x (cancellation
    # in a uniform(-1, 1) x would put f32 rounding above the bound)
    xb = ((np.arange(csr.n) % 10) / 4.0).astype(np.float32)
    np.testing.assert_allclose(op(xb).cpu().numpy(),
                               csr.matvec(xb.astype(np.float64)),
                               rtol=2e-4, atol=1e-4)
