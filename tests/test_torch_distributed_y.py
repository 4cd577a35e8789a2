"""The port's 1-D operator (tilespmv_tpu_torch.parallel.DistributedSpMV on
devices=["cpu"] * 8, the class kernels' plain versions) against the
reference's (tilespmv_tpu.parallel.DistributedSpMV on its 8 virtual CPU
devices, the Pallas kernels in interpret mode) on the same seeded
inputs, for every x mode, on ragged m and n, empty shards and every COO
entry in one shard, and on the xla backend (tile size 8); the
per-shard outputs; the golden.

Tolerance, f32: max |y - y_ref| <= 1e-5 * max(1, max|y_ref|) (the
order of float32 sums differs between the two packages' kernels);
against the float64 golden test_distributed.py's rtol 1e-4 / atol 1e-4.
The f64 and bf16 cases are in test_torch_distributed_dtypes.py."""
import numpy as np
import pytest
import torch

from tilespmv_tpu.config import TileConfig as JConfig
from tilespmv_tpu.parallel import DistributedSpMV as JDist
from tilespmv_tpu.parallel import make_mesh as j_make_mesh
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.config import TileConfig
from tilespmv_tpu_torch.parallel import DistributedSpMV, make_mesh

from test_torch_distributed import CPU8, make

F32_TOL = 1e-5


def golden(csr, x) -> np.ndarray:
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    return np.bincount(rows, weights=csr.data * x[csr.indices].astype(
        np.float64), minlength=csr.m)


def both(name, x_mode, x=None, ndev=8):
    """(port op, y, reference y, x) on MATRICES[name]."""
    jc, tc = make(name)
    if x is None:
        x = np.linspace(-1, 1, tc.n).astype(np.float32)
    op = DistributedSpMV(tc, mesh=make_mesh(ndev, devices=CPU8),
                         x_mode=x_mode)
    y = op(x)
    jy = np.asarray(JDist(jc, mesh=j_make_mesh(ndev), x_mode=x_mode)(x))
    return op, y, jy, x


def close_f32(y: torch.Tensor, want: np.ndarray) -> None:
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    err = float(np.max(np.abs(y.numpy() - want)))
    bound = F32_TOL * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("x_mode", ["allgather", "replicated", "halo",
                                    "auto"])
def test_y_matches_reference(x_mode):
    op, y, jy, x = both("mixed", x_mode)
    assert y.shape == (1024,)
    close_f32(y, jy)
    _, tc = make("mixed")
    np.testing.assert_allclose(y.numpy(), golden(tc, x), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,x_mode", [
    ("uneven", "allgather"), ("uneven", "halo"), ("m100", "halo"),
    ("ragged_n", "halo"), ("banded", "halo"), ("powerlaw", "allgather")])
def test_ragged_and_empty_shards_match_reference(name, x_mode):
    """m not a multiple of ndev * 16, an empty shard (m = 100), n not a
    multiple of ndev * 128, and the band and stream classes."""
    op, y, jy, x = both(name, x_mode)
    close_f32(y, jy)
    _, tc = make(name)
    np.testing.assert_allclose(y.numpy(), golden(tc, x), rtol=2e-4,
                               atol=1e-4)


def test_stream_concentrated_in_one_shard():
    """Every COO entry in shard 0's rows: the other shards run the
    global decision's stream classes with no entries (the reference's
    test_distributed_stream_concentrated_in_one_shard)."""
    op, y, jy, x = both("concentrated", "allgather")
    assert op.use_stream == (True,)
    close_f32(y, jy)
    _, tc = make("concentrated")
    np.testing.assert_allclose(y.numpy(), golden(tc, x), rtol=1e-4,
                               atol=1e-4)


def test_shard_outputs():
    """y's row blocks stay on their shards (the reference returns y
    sharded P('row') over the 8 devices, test_distributed_output_sharding):
    one block of rows_per_device rows per mesh device, their
    concatenation op(x)."""
    _, tc = make("uneven")
    for x_mode in ("allgather", "halo"):
        op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8),
                             x_mode=x_mode)
        x = np.linspace(0.5, 1.5, tc.n).astype(np.float32)
        blocks = op.shard_outputs(x)
        assert len(blocks) == 8
        assert all(b.shape == (op.rows_per_device,) for b in blocks)
        assert [b.device for b in blocks] == op.mesh.flat()
        assert torch.equal(torch.cat(blocks)[: tc.m], op(x))
        # past m the blocks are empty rows
        assert not torch.cat(blocks)[tc.m:].any()
    with pytest.raises(ValueError, match="x has shape"):
        op(np.ones(tc.n + 1))


def test_non_finite_x_meets_no_padding():
    """ROADMAP.md C: the reference unifies its shard plans for one SPMD
    program, and the padding (here the band's extra zero brick columns
    and windows) multiplies x too. With columns 0-127 empty and
    x[0] = Inf, the port's y is each shard's own product, the same as
    a single-device operator on that shard's rows (NaN only where the
    band brick's own zero slots meet the Inf, as in the reference's
    single-device operator); the reference's y has NaN in more rows.
    Where both are finite they agree within the f32 tolerance."""
    from tilespmv_tpu.io import generate as j_gen
    from tilespmv_tpu.io.mmio import CSRMatrix as JCSR
    from tilespmv_tpu_torch.io import generate as t_gen
    from tilespmv_tpu_torch.io.mmio import CSRMatrix as TCSR

    def without_first_block(csr, cls):
        rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
        keep = csr.indices >= 128
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            rows[keep], minlength=csr.m))]).astype(np.int64)
        return cls(csr.shape, indptr, csr.indices[keep], csr.data[keep])

    jc = without_first_block(j_gen.banded(2048, 2048, 8, seed=3), JCSR)
    tc = without_first_block(t_gen.banded(2048, 2048, 8, seed=3), TCSR)
    x = np.linspace(-1, 1, tc.n).astype(np.float32)
    x[0] = np.inf
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8))
    y = op(x).numpy()
    jy = np.asarray(JDist(jc, mesh=j_make_mesh(8))(x))
    single = TileSpMV(tc, device="cpu")(x).numpy()
    bad, jbad = ~np.isfinite(y), ~np.isfinite(jy)
    np.testing.assert_array_equal(bad, ~np.isfinite(single))
    assert bad.any() and np.all(jbad[bad]) and jbad.sum() > bad.sum()
    ok = ~jbad
    assert np.max(np.abs(y[ok] - jy[ok])) <= F32_TOL * max(
        1.0, float(np.max(np.abs(jy[ok]))))


@pytest.mark.parametrize("x_mode", ["allgather", "halo"])
def test_xla_backend_matches_reference(x_mode):
    jc, tc = make("uneven")
    x = np.linspace(-1, 1, tc.n).astype(np.float32)
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=x_mode,
                         config=TileConfig(tile_size=8))
    assert op.backend == "xla"
    jy = np.asarray(JDist(jc, mesh=j_make_mesh(8), x_mode=x_mode,
                          config=JConfig(tile_size=8))(x))
    y = op(x)
    close_f32(y, jy)
    np.testing.assert_allclose(y.numpy(), golden(tc, x), rtol=2e-4,
                               atol=1e-4)
