"""The plain PyTorch stream-pair version (reference.stream2_reference,
stream2.cu's plain version) against tilespmv_tpu's fused 2-RHS Pallas
stream kernel (stream_class_call2) in interpret mode, on identical slabs:
tests/test_torch_stream.py's mono, dual-span, wide-span and
free-placement classes and the two halves of a split dual-span class.
Each case takes its RHS pair (r, r+1) out of an (n, k) X, k in
{2, 5, 16}, and is also held against the exact scatter-add golden.

Tolerance: max |torch - jax| <= 1e-5 * max(1, max|y|) (different f32
summation order)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas import stream_plan as jsp
from tilespmv_tpu_torch.ops.cuda import reference as ref
from test_torch_stream import CASES, TOL, _skewed, _torch_class


def _compare_pair(st, row, col, val, m, n, k, r, seed=0):
    """Run one class on RHS (r, r+1) of a seeded (n, k) X both ways;
    check agreement on the class's windows, that no other column moved,
    and both columns against the golden there."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, k)).astype(
        np.float32)
    rows = -(-n // 128) + jsp.MAX_SPAN_ROWS
    rows = -(-rows // jsp.SPAN_ROWS) * jsp.SPAN_ROWS
    xpad = np.zeros((rows * 128, k), np.float32)
    xpad[:n] = x
    nw = max(1, -(-m // 1024))
    pair = jk.stream_class_call2(
        st, jnp.asarray(xpad[:, r].reshape(-1, 128)),
        jnp.asarray(xpad[:, r + 1].reshape(-1, 128)), nw, interpret=True)
    yt = torch.zeros(nw * 1024, k)
    ref.stream2_reference(_torch_class(st), torch.from_numpy(xpad), yt, r)
    yt = yt.numpy()
    others = [c for c in range(k) if c not in (r, r + 1)]
    assert not yt[:, others].any()
    mine = np.zeros(nw, bool)
    mine[np.asarray(st.cw)] = True
    rows_mine = np.repeat(mine, 1024)
    sel = rows_mine[row]
    for c, yj in zip((r, r + 1), pair):
        yj = np.asarray(yj).reshape(8, nw, 128).transpose(1, 0, 2).reshape(-1)
        err = float(np.max(np.abs(yt[:, c] - yj)[rows_mine]))
        assert err <= TOL * max(1.0, float(np.max(np.abs(yj[rows_mine]))))
        got = np.where(rows_mine, yt[:, c], 0.0)
        gold = np.zeros(nw * 1024)
        np.add.at(gold, row[sel],
                  val[sel] * x[col[sel], c].astype(np.float64))
        assert np.max(np.abs(got - gold) / (1 + np.abs(gold))) < 1e-4


# case -> (k, r): every k, even and odd pair offsets
PAIRS = {"mono_hub_rows": (2, 0), "dual": (5, 3), "wide_span": (16, 14),
         "free_placement": (5, 2)}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_stream2_reference_matches_interpret(case):
    make, kw = CASES[case]
    row, col, val, m, n = make()
    st, _ = jsp.build_stream_chunks(row, col, val, m, **kw)
    _compare_pair(st, row, col, val, m, n, *PAIRS[case])


def test_split_stream2_halves_match_interpret():
    # dual spans: the mono split differs from the mono case only in its
    # window set, which the heavy half here exercises as well
    row, col, val, m, n = _skewed()
    (base, heavy), _ = jsp.build_stream_classes(row, col, val, m,
                                                span_rows=64, dual=True)
    assert heavy is not None
    for st in (base, heavy):
        _compare_pair(st, row, col, val, m, n, 5, 1)
