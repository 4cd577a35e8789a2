"""The plain PyTorch SpMM versions of the band and dense classes
(tilespmv_tpu_torch/ops/cuda/reference.py) against
tilespmv_tpu's fused Pallas SpMM kernels in interpret mode, on the
identical plan (carried across by lane_plan_from_jax), for k in
{2, 5, 16}; the SpMM wrappers' checks and CPU routing; the band
kernels' launch counts (kernels.band_launch); and the plain
SpMM of a plan with stream classes at odd k against the golden. The
W-class is in test_torch_spmm_sparse.py, the stream class in
test_torch_spmm_stream.py, the operator in test_torch_spmm_slice.py.

The Pallas calls return (k*16, n_windows*256) blocks with RHS r at rows
[16r, 16r + 16); each block is held against column r of the port's
(ylen, k) output through window_flat.

Tolerance: max |torch - jax| <= 1e-5 * max(1, max|y|) (different f32
summation order: the interpret path routes by an exact scatter-add)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels
from tilespmv_tpu_torch.ops.cuda import reference as ref
from tilespmv_tpu_torch.ops.spmv import spmm
from test_torch_kernels import close, plans, window_flat, y_len

KS = [2, 5, 16]


def xs_for(n, k, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, k)).astype(
        np.float32)


def panels_k(jplan, x):
    """spmm_pallas's x panels: the k RHS stacked along the lanes."""
    return jnp.concatenate([jk.x_to_panels(jplan, jnp.asarray(x[:, r]))
                            for r in range(x.shape[1])], axis=2)


def run_torch_mm(fn, cls, tplan, x):
    xp = ref.pad_x(tplan, torch.from_numpy(x))
    y = torch.zeros(y_len(tplan), x.shape[1])
    assert fn(cls, xp, y) is y
    return y.numpy()


def close_blocks(got, blocks):
    """got (ylen, k) against the Pallas (k*16, nw*256) output."""
    k = got.shape[1]
    for r in range(k):
        close(got[:, r], window_flat(blocks[16 * r: 16 * r + 16],
                                     got.shape[0]))


@pytest.mark.parametrize("k", KS)
def test_band_spmm_reference_matches_interpret(k):
    jplan, tplan = plans(generate.banded(512, 512, 10, seed=5))
    assert tplan.band is not None
    x = xs_for(jplan.n, k)
    want = np.asarray(jk.band_spmm_call(jplan.band, panels_k(jplan, x),
                                        jplan.n_windows, k, interpret=True))
    close_blocks(run_torch_mm(ref.band_spmm_reference, tplan.band, tplan,
                              x), want)


@pytest.mark.parametrize("k", KS)
def test_dense_spmm_reference_matches_interpret(k):
    """dense_spmm.cu's plain version (dense_active_reference: the active
    lane groups, each tile's nonzero columns) and dense_reference on X
    (n, k), both against one dense_spmm_call in interpret mode."""
    jplan, tplan = plans(generate.mixed_structure(1024, 1024, seed=9))
    assert tplan.dense is not None
    assert ref.dense_spmm_reference is ref.dense_active_reference
    x = xs_for(jplan.n, k)
    want = np.asarray(jk.dense_spmm_call(jplan.dense, panels_k(jplan, x),
                                         jplan.n_windows, k,
                                         interpret=True))
    for plain in (ref.dense_active_reference, ref.dense_reference):
        close_blocks(run_torch_mm(plain, tplan.dense, tplan, x), want)


@pytest.mark.parametrize("k", [1, 8])
def test_band_launch_counts(k):
    """kernels.band_launch on banded_medium's band class (C = 3), counted
    here lane by lane: a block per 32 lanes of a window; the brick, its
    indices, each distinct x block once (16 rows of k values) and the
    y rows read and written."""
    _, plan = plans(generate.get_matrix("banded_medium"))
    bd = plan.band
    nch, C = bd.val.shape[0], bd.val.shape[1]
    bloc, pb = bd.bloc.numpy().reshape(nch, 256), bd.pb.numpy()
    tcs = {int(pb[w * bd.k_panels + ((bloc[w, t] + cb) >> 8)]) * 256
           + ((int(bloc[w, t]) + cb) & 255)
           for w in range(nch) for t in range(256) for cb in range(C)}
    index = 4 * (bloc.size + pb.size + bd.cw.numel())
    got = kernels.band_launch(bd, k=k)
    assert got == dict(
        blocks=nch * 8, val_bytes=bd.val.numel() * 4,
        bytes=(bd.val.numel() * 4 + index + len(tcs) * 16 * 4 * k
               + 2 * nch * 256 * 16 * 4 * k))


def _cpu_plan():
    _, tplan = plans(generate.mixed_structure(512, 512, seed=1))
    return tplan


def test_spmm_wrappers_use_plain_version_on_cpu():
    plan = _cpu_plan()
    x = torch.from_numpy(xs_for(plan.n, 5))
    xp = ref.pad_x(plan, x)
    before = kernels.launch_counts()
    for wrap, plain, cls, extra in (
            (kernels.dense_spmm, ref.dense_spmm_reference, plan.dense, ()),
            (kernels.stream_spmm, ref.stream_rows_reference, plan.stream,
             ())):
        ya = torch.zeros(y_len(plan), 5)
        yb = torch.zeros(y_len(plan), 5)
        assert wrap(cls, xp, ya, *extra) is ya
        plain(cls, xp, yb, *extra)
        assert torch.equal(ya, yb) and ya.abs().max() > 0
    assert kernels.launch_counts() == before
    torch.testing.assert_close(spmm(plan, x), ref.spmm_reference(plan, x))
    assert kernels.launch_counts() == before


def test_stream_pair_touches_only_its_columns():
    """The stream SpMM takes all k columns in one call, each column of y
    from its own column of x only: a zero x column leaves its y column
    zero, and every other column is the planes' SpMV of its x column."""
    plan = _cpu_plan()
    xp = ref.pad_x(plan, torch.from_numpy(xs_for(plan.n, 5)))
    xp[:, 1] = 0
    y = torch.zeros(y_len(plan), 5)
    kernels.stream_spmm(plan.stream, xp, y)
    assert y[:, 1].abs().max() == 0
    for c in (0, 2, 3, 4):
        one = torch.zeros(y_len(plan))
        ref.stream_reference(plan.stream, xp[:, c].contiguous(), one)
        torch.testing.assert_close(y[:, c], one)
        assert one.abs().max() > 0


@pytest.mark.parametrize("k", [1, 17])
def test_fused_wrappers_refuse_k_outside_their_range(k):
    """Each wrapper on a class of its own kind (it checks the class
    before x and y)."""
    plan = _cpu_plan()
    band = TileSpMV(t_gen.banded(512, 512, 10, seed=5),
                    device="cpu").device_plan().band
    sparse, = TileSpMV(t_gen.random_uniform(512, 512, 0.003, seed=3),
                       device="cpu").device_plan().sparses
    xp = torch.zeros(max(plan.x_padded_len, plan.x_padded_len128), k)
    y = torch.zeros(y_len(plan), k)
    for wrap, cls in ((kernels.dense_spmm, plan.dense),
                      (kernels.band_spmm, band),
                      (kernels.sparse_spmm, sparse),
                      (kernels.stream_spmm, plan.stream)):
        with pytest.raises(ValueError, match="k = "):
            wrap(cls, xp, y)


def test_spmm_wrappers_refuse_bad_inputs():
    plan = _cpu_plan()
    rows = max(plan.x_padded_len, plan.x_padded_len128)
    xp = torch.zeros(rows, 4)
    y = torch.zeros(y_len(plan), 4)
    with pytest.raises(ValueError):            # per-entry rows cut short
        kernels.stream_spmm(dataclasses.replace(
            plan.stream, erow=plan.stream.erow[:1]), xp, y)
    with pytest.raises(ValueError):            # column counts differ
        kernels.dense_spmm(plan.dense, xp, torch.zeros(y_len(plan), 3))
    with pytest.raises(ValueError):            # not 2-D
        kernels.dense_spmm(plan.dense, xp[:, 0].contiguous(), y)
    with pytest.raises(ValueError):            # not contiguous
        kernels.dense_spmm(plan.dense, torch.zeros(4, rows).T, y)
    with pytest.raises(ValueError, match="aligned"):   # rows as vectors
        kernels.dense_spmm(plan.dense, xp.view(-1)[1:].view(-1)[
            : rows * 4 - 4].view(rows - 1, 4), y)
    with pytest.raises(TypeError):
        kernels.dense_spmm(plan.dense, xp.double(), y)
    with pytest.raises(ValueError):            # x and y on two devices
        kernels.dense_spmm(plan.dense, xp, y.to("meta"))


@pytest.mark.parametrize("k", [3, 5])
def test_spmm_reference_odd_k_matches_golden(k):
    """Odd k takes the stream classes in the same one call per class as
    even k: TileSpMV(device="cpu").matmat on a plan of a split stream
    pair (stream, stream2) against the float64 CSR golden (rtol 2e-4,
    atol 1e-4), with no kernel launched."""
    csr = t_gen.power_law(32768, 32768, 16, seed=9)
    op = TileSpMV(csr, device="cpu")
    plan = op.device_plan()
    assert plan.stream is not None and plan.stream2 is not None
    x = xs_for(csr.n, k, seed=k)
    before = kernels.launch_counts()
    y = op.matmat(x).numpy()
    assert kernels.launch_counts() == before
    want = np.stack([csr.matvec(x[:, r].astype(np.float64))
                     for r in range(k)], axis=1)
    np.testing.assert_allclose(y, want, rtol=2e-4, atol=1e-4)
