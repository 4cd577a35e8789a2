"""The generators: HPCG's stencil and GAP's kron graph, at small sizes."""
import numpy as np
import pytest
import torch

from benchmark import harness

VALUES = np.arange(1, 11) / 4


def _gen(name, cfg, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    m, n, indptr, indices, data = harness.plugin("generators", name).generate(
        cfg, g, torch.device("cpu"), dtype)
    return m, n, indptr.numpy(), indices.numpy(), data.numpy()


def _dense(m, n, indptr, indices, data):
    a = np.zeros((m, n))
    rows = np.repeat(np.arange(m), np.diff(indptr))
    a[rows, indices] = data
    return a


@pytest.mark.parametrize("nx,ny,nz", [(3, 3, 3), (4, 4, 4), (5, 3, 2),
                                      (1, 2, 7)])
def test_hpcg_nnz_and_order(nx, ny, nz):
    m, n, indptr, indices, data = _gen("hpcg27",
                                       dict(nx=nx, ny=ny, nz=nz), 1)
    assert m == n == nx * ny * nz
    assert indptr[-1] == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    for r in range(m):
        cols = indices[indptr[r]:indptr[r + 1]]
        assert np.all(np.diff(cols) > 0)
        assert r in cols
    assert set(np.unique(data)) <= set(VALUES)


def test_hpcg_neighbours_are_the_stencil():
    nx, ny, nz = 4, 3, 5
    m, n, indptr, indices, data = _gen("hpcg27", dict(nx=nx, ny=ny, nz=nz), 2)
    a = _dense(m, n, indptr, indices, data) != 0
    coord = lambda i: np.array([i % nx, (i // nx) % ny, i // (nx * ny)])
    for i in range(m):
        for j in range(n):
            assert a[i, j] == (np.abs(coord(i) - coord(j)).max() <= 1)


KRON = dict(scale=9, degree=16, A=0.57, B=0.19, C=0.19)


def test_kron_undirected_simple_graph():
    m, n, indptr, indices, data = _gen("kron", KRON, 3, torch.float32)
    assert m == n == 512
    a = _dense(m, n, indptr, indices, data)
    assert np.array_equal(a, a.T)            # symmetric, values too
    assert not np.diagonal(a).any()          # no self-loops
    rows = np.repeat(np.arange(m), np.diff(indptr))
    assert np.unique(rows * n + indices).size == indices.size   # no dups
    for r in range(m):
        assert np.all(np.diff(indices[indptr[r]:indptr[r + 1]]) > 0)
    assert set(np.unique(data)) <= set(VALUES)
    # about 2 * degree * 2**scale nonzeros, less the duplicates
    assert 0.5 * 2 * 16 * 512 < indices.size <= 2 * 16 * 512


def test_kron_skewed_degrees():
    m, n, indptr, *_ = _gen("kron", dict(KRON, scale=12), 4, torch.float32)
    deg = np.diff(indptr)
    assert deg.max() > 20 * deg.mean()


def test_generators_repeat_for_a_seed():
    for name, cfg in (("kron", KRON), ("hpcg27", dict(nx=3, ny=4, nz=5))):
        a = _gen(name, cfg, 7)
        b = _gen(name, cfg, 7)
        c = _gen(name, cfg, 8)
        for u, v in zip(a[2:], b[2:]):
            assert np.array_equal(u, v)
        assert not all(np.array_equal(u, v) and u.shape == v.shape
                       for u, v in zip(a[2:], c[2:]))
