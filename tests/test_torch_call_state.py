"""The operator's call state (ops/spmv.py `_CallState`): built at an
operator's first call, reused by every later one, dropped when the
buffers move or are replaced.

On the CPU each call of `op` / `op.matmat` is bit-equal to the
functional `spmv(op.device_plan(), x)` / `spmm(...)`, which run a call
state made for the call and count no build, and check x with the
operator's message, over f32, f64 and bf16 plans of test_torch_spans.py's
matrices;
`spans.state_builds()` rises by one an operator (a column part and `.T`
are operators of their own) and by one more after `_apply` or a replaced
buffer; each call gives a y of its own, and the padded x it keeps has a
zero tail. On a faked kernel library each class's launch passes what its
C entry point declares (the CUDA branch runs only on the card)."""
import copy
import ctypes

import pytest
import torch

from test_torch_spans import DTYPES, FORWARD_CASES, operator
from tilespmv_tpu_torch import TileSpMV, spans
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops.cuda import build, kernels
from tilespmv_tpu_torch.ops.cuda.reference import class_order, pad_x, zero_y
from tilespmv_tpu_torch.ops.spmv import spmm, spmv

K = 4
CASES = [(name, dtype, kind) for name, dtype in sorted(FORWARD_CASES)
         for kind in ("spmv", "matmat")]


def xs(op, kind, count=3, seed=0):
    """`count` x's (X's of K columns for matmat) in op's dtype."""
    gen = torch.Generator().manual_seed(seed)
    shape = (op.shape[1],) if kind == "spmv" else (op.shape[1], K)
    return [(torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1)
            .to(op.dtype) for _ in range(count)]


def call(op, kind, x):
    return op(x) if kind == "spmv" else op.matmat(x)


def functional(op, kind, x):
    fn = spmv if kind == "spmv" else spmm
    return fn(op.device_plan(), x)


@pytest.mark.parametrize("name,dtype,kind", CASES)
def test_calls_match_the_functional_path(name, dtype, kind):
    _, op = operator(name, dtype)
    before = spans.state_builds()
    for x in xs(op, kind):
        assert torch.equal(call(op, kind, x), functional(op, kind, x))
    assert spans.state_builds() == before + 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["spmv", "matmat"])
def test_moved_buffers_rebuild_the_state(dtype, kind):
    """After `_apply` (what `.to()` goes through) the next call builds the
    state from the new buffers: y follows a change made to them."""
    _, op = operator("mixed" if dtype != "bf16" else "hyb", dtype)
    (x,) = xs(op, kind, 1)
    y = call(op, kind, x)
    before = spans.state_builds()
    op._apply(lambda t: t.clone())
    for name, b in op.named_buffers():
        if name.endswith("_val"):
            b.mul_(2)
    y2 = call(op, kind, x)
    assert spans.state_builds() == before + 1
    assert torch.equal(y2, 2 * y)
    assert torch.equal(y2, functional(op, kind, x))
    assert torch.equal(call(op, kind, x), y2)
    assert spans.state_builds() == before + 1


def test_replaced_buffer_rebuilds_the_state():
    _, op = operator("mixed")
    (x,) = xs(op, "spmv", 1)
    y = op(x)
    before = spans.state_builds()
    op.dense_val = op.dense_val * 3
    y2 = op(x)
    assert spans.state_builds() == before + 1
    assert not torch.equal(y2, y)
    assert torch.equal(y2, functional(op, "spmv", x))


def test_copies_leave_the_state_behind():
    _, op = operator("mixed")
    (x,) = xs(op, "spmv", 1)
    y = op(x)
    dup = copy.deepcopy(op)
    assert dup._state is None and op._state is not None
    with torch.no_grad():
        for b in dup.buffers():
            b.zero_()
    assert torch.equal(op(x), y)
    assert not dup(x).any()


@pytest.mark.parametrize("kind", ["spmv", "matmat"])
def test_each_call_gets_its_own_y(kind):
    _, op = operator("mixed")
    x1, x2 = xs(op, kind, 2)
    y1 = call(op, kind, x1)
    keep = y1.clone()
    y2 = call(op, kind, x2)
    assert y1.untyped_storage().data_ptr() != \
        y2.untyped_storage().data_ptr()
    assert torch.equal(y1, keep)
    assert torch.equal(y2, functional(op, kind, x2))


def test_padded_x_is_kept_with_a_zero_tail():
    _, op = operator("two_rate")
    x1, x2 = xs(op, "spmv", 2)
    op(x1)
    ((key, (xp, head)),) = op._state.pads.items()
    assert key == ((), None) and head.data_ptr() == xp.data_ptr()
    op(x2)
    assert op._state.pads[key][0] is xp
    n = op.shape[1]
    assert xp.shape[0] > n and not xp[n:].any()
    assert torch.equal(xp[:n], x2)
    X = xs(op, "matmat", 1)[0]
    op.matmat(X)
    assert sorted(op._state.pads) == [((), None), ((K,), None)]


@pytest.mark.parametrize("first", [True, False])
def test_wrong_shapes_raise_as_before(first):
    """The same errors whether or not the state is there yet."""
    csr, op = operator("mixed")
    n = csr.n
    if not first:
        op(torch.zeros(n))
    with pytest.raises(ValueError,
                       match=rf"^x has shape \({n + 1},\), expected \({n},\)"):
        op(torch.zeros(n + 1))
    with pytest.raises(ValueError, match=r"^x has shape .* expected"):
        op(torch.zeros(n, 2))
    with pytest.raises(ValueError,
                       match=rf"^X has shape \({n},\), expected \({n}, k\)"):
        op.matmat(torch.zeros(n))
    with pytest.raises(ValueError, match=r"^X has shape"):
        op.matmat(torch.zeros(n - 1, 3))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_functional_path_raises_the_operators_message(dtype):
    """spmv / spmm on a plan check x as the operator does, with its
    message, and count no state build."""
    _, op = operator("mixed" if dtype != "bf16" else "hyb", dtype)
    plan = op.device_plan()
    n = plan.n
    before = spans.state_builds()
    with pytest.raises(ValueError, match=rf"^x has shape \({n + 1},\), "
                       rf"expected \({n},\)$"):
        spmv(plan, torch.zeros(n + 1))
    with pytest.raises(ValueError, match=rf"^X has shape \({n},\), "
                       rf"expected \({n}, k\)$"):
        spmm(plan, torch.zeros(n))
    with pytest.raises(ValueError, match=r"^X has shape"):
        spmm(plan, torch.zeros(n - 1, K))
    spmv(plan, torch.zeros(n))
    spmm(plan, torch.zeros(n, K))
    assert spans.state_builds() == before


@pytest.mark.parametrize("kind", ["spmv", "matmat"])
def test_column_parts_build_a_state_each(kind):
    csr = generate.mixed_structure(256, 1024, seed=9)
    op = TileSpMV(csr, device="cpu", max_cols_per_plan=256)
    assert len(op.parts) == 4
    before = spans.state_builds()
    for x in xs(op, kind):
        want = None
        for c0, part in zip(op._col_starts, op.parts):
            yk = functional(part, kind, x[c0: c0 + part.shape[1]])
            want = yk if want is None else want + yk
        assert torch.equal(call(op, kind, x), want)
    assert spans.state_builds() == before + 4
    assert op._state is None


@pytest.mark.parametrize("kind", ["spmv", "matmat"])
def test_transpose_builds_its_own_state(kind):
    csr = generate.mixed_structure(300, 500, seed=4)
    op = TileSpMV(csr, device="cpu")
    t = op.T
    before = spans.state_builds()
    for x in xs(t, kind):
        assert torch.equal(call(t, kind, x), functional(t, kind, x))
    assert spans.state_builds() == before + 1
    assert op._state is None


@pytest.mark.parametrize("kind", ["spmv", "matmat"])
def test_xla_backend_keeps_its_plan(kind):
    csr = generate.mixed_structure(512, 512, seed=7)
    op = TileSpMV(csr, device="cpu", backend="xla")
    before = spans.state_builds()
    for x in xs(op, kind):
        assert torch.equal(call(op, kind, x), functional(op, kind, x))
    assert spans.state_builds() == before + 1
    assert op._state.mv is None and not op._state.pads


class _FakeLib:
    """Entry points that check each argument against the C signature
    (ctypes' from_param) and record the call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def fn(*args):
            types = build.ENTRY_POINTS[entry]
            assert len(args) == len(types), entry
            for a, t in zip(args, types):
                t.from_param(a)
            self.calls.append((entry, args))
            return 0
        return fn


@pytest.mark.parametrize("name,dtype,mm", [
    ("mixed", "f32", False), ("mixed", "f32", True), ("banded", "f32", False),
    ("banded", "f32", True), ("w16", "f32", False), ("w16", "f32", True),
    ("two_rate", "f32", True), ("mixed", "f64", False),
    ("hyb", "bf16", False), ("hyb", "bf16", True)])
def test_launch_arguments_fit_the_entry_points(name, dtype, mm, monkeypatch):
    """Each class's ClassLaunch, made as on the card (on a faked library
    and stream), passes its entry point's argument count and types, x and
    y after the plan arguments, k where SpMM takes it, the stream last,
    and counts one launch; its wrapper passes the same."""
    lib, stream = _FakeLib(), 0x5EED
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(kernels, "_use_kernel", lambda dev: True)
    monkeypatch.setattr(kernels, "_stream", lambda: stream)
    _, op = operator(name, dtype)
    plan = op.device_plan()
    x = pad_x(plan, torch.ones((plan.n, K) if mm else plan.n))
    y = zero_y(plan, x)
    wrap = {"band": kernels.band_spmm if mm else kernels.band_spmv,
            "dense": kernels.dense_spmm if mm else kernels.dense_spmv,
            "sparse": kernels.sparse_spmm if mm else kernels.sparse_spmv,
            "stream": kernels.stream_spmm if mm else kernels.stream_spmv}
    for _, kind, cls in class_order(plan):
        launch = kernels.ClassLaunch(kind, cls, x.device, mm=mm)
        before = kernels.launch_counts()[launch.name]
        launch(x, y)
        entry, args = lib.calls[-1]
        assert entry == "tsp_" + launch.name
        assert kernels.launch_counts()[launch.name] == before + 1
        at = len(launch.head)
        assert args[at: at + 2] == (x.data_ptr(), y.data_ptr())
        ks = args[at + 2 + len(launch.tail): -1]
        assert ks == ((K,) * (2 if kind == "stream" else 1) if mm else ())
        assert args[-1] == stream
        wrap[kind](cls, x, y)
        assert [ctypes.cast(a, ctypes.c_void_p).value
                if isinstance(a, ctypes.c_void_p) else a
                for a in lib.calls[-1][1]] == \
            [ctypes.cast(a, ctypes.c_void_p).value
             if isinstance(a, ctypes.c_void_p) else a for a in args]
