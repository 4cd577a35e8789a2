"""reference.py against a dense product, and the gap it measures."""
import numpy as np
import pytest

from benchmark import reference


def _csr(rng, m, n, density, empty_rows=()):
    a = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    a[list(empty_rows)] = 0
    indptr = np.concatenate([[0], np.cumsum((a != 0).sum(1))])
    rows, cols = np.nonzero(a)
    return a, indptr, cols.astype(np.int32), a[rows, cols]


@pytest.mark.parametrize("k", [1, 3])
def test_product_matches_dense(k, monkeypatch):
    rng = np.random.default_rng(0)
    a, indptr, indices, data = _csr(rng, 70, 50, 0.2,
                                    empty_rows=(0, 5, 6, 69))
    x = rng.standard_normal((50,) if k == 1 else (50, k))
    # small blocks, so that rows are cut into many blocks
    monkeypatch.setattr(reference, "BLOCK_NNZ", 16)
    y, s = reference.product(indptr, indices, data, x)
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s, np.abs(a) @ np.abs(x), rtol=1e-12)
    assert not y[[0, 5, 6, 69]].any()


def test_product_of_float32_values_is_exact_in_float64():
    rng = np.random.default_rng(1)
    a, indptr, indices, data = _csr(rng, 30, 30, 0.3)
    data32 = data.astype(np.float32)
    y, _ = reference.product(indptr, indices, data32, np.ones(30))
    rows = np.repeat(np.arange(30), np.diff(indptr))
    want = np.zeros(30)
    np.add.at(want, rows, data32.astype(np.float64))
    np.testing.assert_allclose(y, want, rtol=1e-15)


def test_gap():
    want = np.array([1.0, -2.0, 0.0])
    scale = np.array([2.0, 4.0, 0.0])
    assert reference.gap(want, want, scale) == 0
    assert reference.gap(np.array([1.5, -2.0, 0.0]), want,
                         scale) == pytest.approx(0.25)
    # a row of scale 0 must be 0 exactly; non-finite reads inf
    assert reference.gap(np.array([1.0, -2.0, 1e-30]), want, scale) == np.inf
    assert reference.gap(np.array([np.nan, -2.0, 0.0]), want, scale) == np.inf
    assert reference.gap(np.array([1.0, np.inf, 0.0]), want, scale) == np.inf
