"""The W-class kernel (csrc/sparse.cu, a persistent grid whose blocks
walk the class's chunks through a ring of shared-memory stages fed by
bulk copies) against its plain version, `reference.sparse_rows_reference`,
on the card, f32 and bf16 values: within 1e-5 * max(1, max|y|) (f32
atomics add in an order that changes from run to run), NaN for NaN and
Inf for Inf where x holds them.

Cases: every W of W_CHOICES on a class of fewer chunks than SMs (c_batch
4), one chunk of it, its chunks repeated until every block wraps its
ring more than once, its meta rows at the prefix route's stride (the
boundary rows filled with junk the kernel must not read), its steps at
k_panels 8 with every panel slot in use; a class at k_panels 1; one tile
row spread over 4,096 tiles (the leader merge); HPCG's stencil at 64^3;
an Inf and a NaN in x; buffers the kernel refuses. Marked `cuda`:
skipped where there is no GPU.
Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sparse_ring.py

On the CPU: each W-class launch passes its C entry point's signature and
what the kernel refuses otherwise (T = 128, 16-byte aligned values,
meta, x and y; meta rows at or above the class's own; 1-8 panels), on a
faked library, from the wrapper and from scripts/sparse_probes."""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_call_state import _FakeLib
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops.cuda import build, kernels, lane_plan, reference
from tilespmv_tpu_torch.scripts import sparse_probes

TOL = 1e-5
BF16 = torch.bfloat16
DTYPES = (torch.float32, BF16)
# the fewest entries of a tile of each W-class: one above the next
# narrower class's W - 1
LO = {16: 1, 24: 16, 32: 24, 48: 32, 64: 48, 96: 64}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def w_csr(width: int, n: int = 8192, seed: int = 0):
    """600 tiles of one W-class, two on each of tile rows 0..299, a third
    of them with W - 1 entries, each with row 0, 7 or 15 empty; n columns
    (n = 4096: one x panel)."""
    rng = np.random.default_rng(seed + width)
    lo = LO[width]
    rows, cols = [], []
    for i in range(600):
        tr = i // 2
        tc = (tr * 37 + (i % 2) * 211) % (n // 16)
        cnt = width - 1 if i % 3 == 0 else lo + i % (width - 1 - lo)
        empty = (0, 7, 15)[(i // 3) % 3]
        cells = np.flatnonzero(np.arange(256) // 16 != empty)
        pick = rng.choice(cells, cnt, replace=False)
        rows.append(tr * 16 + pick // 16)
        cols.append(tc * 16 + pick % 16)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return generate.csr_from_coo(8192, n, rows, cols,
                                 rng.standard_normal(rows.size))


def one_row_csr(seed: int = 0):
    """4096 x 65536 whose tile row 0 holds a tile of 20 entries in every
    tile column: 4,096 tiles of one W-class on one tile row."""
    rng = np.random.default_rng(seed)
    ntc = 65536 // 16
    cells = np.concatenate([rng.choice(256, 20, replace=False)
                            for _ in range(ntc)])
    cols = np.repeat(np.arange(ntc), 20) * 16 + cells % 16
    return generate.csr_from_coo(4096, 65536, cells // 16, cols,
                                 rng.standard_normal(cells.size))


def one_chunk(s):
    """The class's first chunk alone, as a class of one step."""
    return dataclasses.replace(
        s, val=s.val[:1].contiguous(), meta=s.meta[:1].contiguous(),
        pb=s.pb[:s.k_panels].contiguous(), cw=s.cw[:1].contiguous(),
        cfirst=s.cfirst[:1].contiguous(), c_batch=1)


def repeated(s, times: int):
    """The class's steps `times` times over (each adds into y again)."""
    def rep(a):
        return a.repeat((times,) + (1,) * (a.dim() - 1)).contiguous()
    return dataclasses.replace(s, val=rep(s.val), meta=rep(s.meta),
                               pb=rep(s.pb), cw=rep(s.cw),
                               cfirst=rep(s.cfirst))


def prefix_stride(s, seed: int = 0):
    """The class with the prefix route's boundary rows after its meta
    rows, filled with junk."""
    extra = lane_plan.prefix_rows(s.t_lanes, "prefix")
    g = torch.Generator(device="cpu").manual_seed(seed)
    junk = torch.randint(-2**31, 2**31 - 1, (s.meta.shape[0], extra,
                         s.t_lanes), generator=g, dtype=torch.int32)
    return dataclasses.replace(
        s, meta=torch.cat([s.meta, junk.to(s.meta.device)], 1).contiguous(),
        route="prefix")


def eight_panels(s):
    """The class (at most 4 panels a step) at k_panels 8: its panel ids
    in slots 4..7 and, reversed, in slots 3..0; odd lanes read theirs
    from slot p + 4, even lanes from slot 3 - p."""
    K = s.k_panels
    assert K <= 4
    pb = s.pb.view(-1, K)
    pb4 = torch.cat([pb, pb[:, -1:].expand(-1, 4 - K)], 1)
    pb8 = torch.cat([pb4.flip(1), pb4], 1).contiguous().view(-1)
    xloc = s.meta[:, 0]
    p, col = xloc >> 8, xloc & 255
    odd = (torch.arange(s.t_lanes, device=xloc.device) % 2 == 1)[None, :]
    new = torch.where(odd, p + 4, 3 - p) * 256 + col
    meta = s.meta.clone()
    meta[:, 0] = torch.where(xloc >= 0, new, xloc)
    return dataclasses.replace(s, meta=meta, pb=pb8, k_panels=8)


def one_panel(s):
    """The class (every lane on its step's first panel slot) at
    k_panels 1."""
    act = s.meta[:, 0] >= 0
    assert bool(((s.meta[:, 0] >> 8)[act] == 0).all())
    pb = s.pb.view(-1, s.k_panels)[:, :1].contiguous().view(-1)
    return dataclasses.replace(s, pb=pb, k_panels=1)


def nonfinite_x(s, x: torch.Tensor, xp_of) -> torch.Tensor:
    """x with an Inf at the column of the class's first entry and a NaN
    at its last one's."""
    cols = reference.class_coo(s)[1]
    xb = x.clone()
    xb[int(cols[0])] = float("inf")
    xb[int(cols[-1])] = float("nan")
    return xp_of(xb)


def agree(yk: torch.Tensor, yp: torch.Tensor) -> None:
    """NaN for NaN and Inf for Inf (sign included), the finite entries
    within TOL * max(1, max|plain|)."""
    assert torch.equal(yk.isnan(), yp.isnan())
    assert torch.equal(yk.isinf() & (yk > 0), yp.isinf() & (yp > 0))
    assert torch.equal(yk.isinf() & (yk < 0), yp.isinf() & (yp < 0))
    fin = yp.isfinite()
    err = float((yk[fin] - yp[fin]).abs().max())
    assert err <= TOL * max(1.0, float(yp[fin].abs().max())), err


def check(s, xp: torch.Tensor, ylen: int) -> None:
    """One launch of the W-class kernel on `s` against the plain
    version, counted once."""
    key = "sparse" + ("_bf16" if s.val.dtype == BF16 else "")
    before = kernels.launch_counts()[key]
    yk = kernels.sparse_spmv(s, xp, torch.zeros(ylen, device=xp.device))
    assert kernels.launch_counts()[key] == before + 1
    yp = reference.sparse_rows_reference(
        s, xp, torch.zeros(ylen, device=xp.device))
    torch.cuda.synchronize()
    agree(yk, yp)


def _setup(csr, dtype, device):
    """(plan, padded-x maker, x, ylen) of csr's operator in `dtype`."""
    plan = TileSpMV(csr, device=device, dtype=dtype).device_plan()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, csr.n).astype(np.float32)).to(device)

    def xp_of(v):
        return reference.pad_x(plan, v)
    ylen = reference.zero_y(plan, xp_of(x)).shape[0]
    return plan, xp_of, x, ylen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("width", lane_plan.W_CHOICES)
def test_ring_on_every_width(width, dtype, device):
    """A class of W: as planned (fewer chunks than SMs, c_batch > 1),
    one chunk of it, its chunks repeated until each block wraps its ring
    more than once, at the prefix route's meta stride, at k_panels 8
    with all eight slots read; then with an Inf and a NaN in x."""
    plan, xp_of, x, ylen = _setup(w_csr(width), dtype, device)
    s, = plan.sparses
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert s.width == width and s.c_batch > 1
    assert s.val.shape[0] < sms
    # at most two blocks an SM, each of at most 4 stages: every block
    # takes more than 3 rounds of its ring
    times = -(-3 * 4 * 2 * sms // s.val.shape[0]) + 1
    cases = [s, one_chunk(s), repeated(s, times), prefix_stride(s)]
    if s.k_panels <= 4:
        cases.append(eight_panels(s))
    else:
        assert s.k_panels == 8
    xp = xp_of(x)
    for c in cases:
        check(c, xp, ylen)
    check(s, nonfinite_x(s, x, xp_of), ylen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_ring_at_one_and_eight_panels(dtype, device):
    """A W32 class on one x panel at k_panels 1, and the same class with
    its panel ids spread over eight slots."""
    plan, xp_of, x, ylen = _setup(w_csr(32, n=4096), dtype, device)
    s, = plan.sparses
    s1 = one_panel(s)
    for c in (s1, eight_panels(s1)):
        check(c, xp_of(x), ylen)
    check(s1, nonfinite_x(s1, x, xp_of), ylen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_ring_merges_one_tile_row(dtype, device):
    """One tile row over 4,096 tiles of one class: every warp's lanes
    add into one leader."""
    plan, xp_of, x, ylen = _setup(one_row_csr(), dtype, device)
    s, = plan.sparses
    assert sparse_probes.class_tiles(s)["most"] == 4096
    check(s, xp_of(x), ylen)
    check(s, nonfinite_x(s, x, xp_of), ylen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_ring_on_the_hpcg_stencil(dtype, device):
    """HPCG's 27-point stencil at 64^3 (one W64 class of about 1,500
    chunks, c_batch 8), and with an Inf and a NaN in x."""
    csr = generate.stencil_27(64, 64, 64, seed=2, dtype=np.float32)
    plan, xp_of, x, ylen = _setup(csr, dtype, device)
    assert plan.sparses
    for s in plan.sparses:
        check(s, xp_of(x), ylen)
        check(s, nonfinite_x(s, x, xp_of), ylen)


@pytest.mark.cuda
def test_ring_refuses_what_it_cannot_copy(device):
    """The C entry refuses (a nonzero error, nothing launched) values,
    meta, x or y off 16 bytes, T other than 128 and meta rows below the
    class's own; the wrapper and ClassLaunch raise ValueError, naming
    the argument, on an x or y view off 16 bytes."""
    plan, xp_of, x, ylen = _setup(w_csr(24), torch.float32, device)
    s, = plan.sparses
    xp = xp_of(x)
    y = torch.zeros(ylen + 4, device=device)
    args = [s.val.data_ptr(), s.meta.data_ptr(), s.pb.data_ptr(),
            s.cw.data_ptr(), xp.data_ptr(), y.data_ptr(), s.val.shape[0],
            s.width, s.t_lanes, s.meta.shape[1], s.k_panels, s.c_batch]
    lib = build.load()

    def err(i, v):
        a = list(args)
        a[i] = v
        return lib.tsp_sparse(*a, kernels._stream())
    assert err(5, args[5]) == 0
    for i in (0, 1, 4, 5):
        assert err(i, args[i] + 4) != 0, i
    assert err(8, 64) != 0 and err(9, 2 + s.width // 8 + 3) != 0
    xs = torch.zeros(xp.numel() + 4, device=device)
    launch = kernels.ClassLaunch("sparse", s, xp.device)
    before = kernels.launch_counts()["sparse"]
    for fn in (kernels.sparse_spmv, lambda _, x_, y_: launch(x_, y_)):
        with pytest.raises(ValueError, match="sparse: y must start "
                           "16-byte aligned"):
            fn(s, xp, y[1:1 + ylen])
        with pytest.raises(ValueError, match="sparse: x must start "
                           "16-byte aligned"):
            fn(s, xs[1:1 + xp.numel()], y[:ylen])
    assert kernels.launch_counts()["sparse"] == before
    torch.cuda.synchronize()


def _value(a):
    return (ctypes.cast(a, ctypes.c_void_p).value
            if isinstance(a, ctypes.c_void_p) else a)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("case", ["widths", "stencil", "prefix"])
def test_launch_arguments_fit_the_ring_kernel(case, dtype, monkeypatch):
    """Each W-class launch, made as on the card (on a faked library and
    stream), passes tsp_sparse's (tsp_sparse_bf16's) arguments: the
    class's four plan arrays, x, y, then chunks, W, T, its meta stride,
    k_panels and c_batch, the stream last; what the kernel refuses is
    not there (T = 128, the pointers 16-byte aligned, meta rows at or
    above 2 + W/8 + 4, 1 to 8 panels, chunks a multiple of c_batch); the
    probe script's launcher (f32) passes the same."""
    lib, stream = _FakeLib(), 0x5EED
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(kernels, "_use_kernel", lambda dev: True)
    monkeypatch.setattr(kernels, "_stream", lambda: stream)
    monkeypatch.setattr(build, "arm_libs",
                        lambda source, kept, edits, entries: {kept: lib})
    csrs = {"widths": [w_csr(w) for w in (16, 48, 96)],
            "stencil": [generate.stencil_27(24, 24, 24, dtype=np.float32)],
            "prefix": [w_csr(24)]}[case]
    entry = "tsp_sparse" + ("_bf16" if dtype == BF16 else "")
    for csr in csrs:
        plan = TileSpMV(csr, device="cpu", dtype=dtype).device_plan()
        x = reference.pad_x(plan, torch.ones(plan.n))
        y = reference.zero_y(plan, x)
        classes = list(plan.sparses)
        if case == "prefix":
            classes = [prefix_stride(s) for s in classes]
        assert classes
        for s in classes:
            launch = kernels.ClassLaunch("sparse", s, x.device)
            launch(x, y)
            got, args = lib.calls[-1]
            args = tuple(_value(a) for a in args)
            assert got == entry
            nch, W = s.val.shape[0], s.width
            assert args[:6] == (*(t.data_ptr() for t in (
                s.val, s.meta, s.pb, s.cw)), x.data_ptr(), y.data_ptr())
            assert args[6:] == (nch, W, s.t_lanes, s.meta.shape[1],
                                s.k_panels, s.c_batch, stream)
            assert s.t_lanes == lane_plan.SPARSE_T == 128
            assert all(p % 16 == 0 for p in args[:6])
            assert s.meta.shape[1] >= 2 + W // 8 + 4
            assert 1 <= s.k_panels <= 8 and nch % s.c_batch == 0
            if case == "prefix":
                assert s.meta.shape[1] == lane_plan.sparse_meta_rows(W) + 4
            if dtype == torch.float32:
                sparse_probes._launcher(sparse_probes.KEPT, [s], x, y)()
                probe_entry, probe_args = lib.calls[-1]
                assert probe_entry == entry
                assert tuple(_value(a) for a in probe_args) == args


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_wrapper_refuses_views_off_16_bytes(dtype):
    """kernels.sparse_spmv and ClassLaunch refuse, by a ValueError that
    names the argument, an x or a y that starts off 16 bytes (the kernel
    reads x blocks and adds into y as float4), on the CPU too; the same
    call on aligned x and y is the plain version's."""
    plan = TileSpMV(w_csr(24), device="cpu", dtype=dtype).device_plan()
    s, = plan.sparses
    x = reference.pad_x(plan, torch.ones(plan.n))
    ylen = reference.zero_y(plan, x).shape[0]
    xs, ys = torch.zeros(x.numel() + 4), torch.zeros(ylen + 4)
    xs[1:1 + x.numel()] = x
    name = "sparse" + ("_bf16" if dtype == BF16 else "")
    launch = kernels.ClassLaunch("sparse", s, x.device)
    for fn in (kernels.sparse_spmv, lambda _, x_, y_: launch(x_, y_)):
        with pytest.raises(ValueError, match=f"{name}: y must start"):
            fn(s, x, ys[1:1 + ylen])
        with pytest.raises(ValueError, match=f"{name}: x must start"):
            fn(s, xs[1:1 + x.numel()], ys[:ylen])
        got = fn(s, x, ys[4:4 + ylen].zero_())
        want = reference.sparse_rows_reference(s, x, torch.zeros(ylen))
        assert torch.equal(got, want)
