"""The port's host utilities (tilespmv_tpu_torch/utils/host.py) against
tilespmv_tpu.utils.host: scans, the boundary search, the key/value sort
and the CSR transpose, bit-equal."""
import numpy as np
import pytest

from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.utils import host as j_host
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.utils import (binary_search_right_boundary,
                                      csr_transpose, exclusive_scan,
                                      sort_key_val)

from test_torch_plan import make

# rectangular both ways, empty rows and columns, duplicate-heavy rows
TRANSPOSE_CASES = ("mixed", "partial_tiles", "rectangular",
                   "empty_stripes", "duplicate_heavy", "hypersparse")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("counts", [[3, 1, 4], [], [0, 0, 7, 0]])
def test_exclusive_scan_matches_reference(counts):
    _same(exclusive_scan(counts), j_host.exclusive_scan(counts))
    _same(exclusive_scan(np.array(counts, np.int32), dtype=np.int32),
          j_host.exclusive_scan(np.array(counts, np.int32), dtype=np.int32))


def test_binary_search_and_sort_match_reference():
    rng = np.random.default_rng(0)
    b = np.cumsum(rng.integers(0, 5, 50))
    keys = rng.integers(0, int(b[-1]) + 3, 200)
    _same(binary_search_right_boundary(b, keys),
          j_host.binary_search_right_boundary(b, keys))
    k = rng.integers(0, 20, 300)
    v = rng.standard_normal(300)
    for a, r in zip(sort_key_val(k, v), j_host.sort_key_val(k, v)):
        _same(a, r)


@pytest.mark.parametrize("name", TRANSPOSE_CASES)
def test_csr_transpose_matches_reference(name):
    tc = csr_transpose(make(t_gen, name))
    jc = j_host.csr_transpose(make(j_gen, name))
    assert tc.shape == jc.shape
    for f in ("indptr", "indices", "data"):
        _same(getattr(tc, f), getattr(jc, f))
    # and it is the transpose
    csr = make(t_gen, name)
    np.testing.assert_array_equal(tc.to_dense(), csr.to_dense().T)
    back = csr_transpose(tc)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(back, f), getattr(csr, f))
