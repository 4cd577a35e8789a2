"""The port's measurement layer (tilespmv_tpu_torch.utils) against the
reference's (tilespmv_tpu.utils) on the CPU.

`profile_engines` on a CPU operator returns the reference plan's class
keys; for f32 plans its `bytes` and count fields equal those the
reference's profile_engines computes from its plan (profiling.py:83-141,
reckoned here from the JAX LanePlan's arrays: the reference's own
profile_engines would run 2 * (25 + 425) interpret-mode Pallas calls per
class). f64 plans keep value arrays of another layout (the reference a
hi/lo f32 pair, the port one float64 array), so for f64 only the keys and
counts are compared. `interleaved_ab` of both packages, each with its
`_timed` replaced by one recorder, must make the same calls in the same
order and return the same result."""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tilespmv_tpu as jpkg
import tilespmv_tpu_torch as tpkg
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan
from tilespmv_tpu.utils import abtest as j_abtest
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels, lane_plan
from tilespmv_tpu_torch.utils import abtest, profiling

from test_torch_plan import _skewed

HYB = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)


def _split(pkg):
    row, col, val, m = _skewed()
    return pkg.tile_create(pkg.csr_from_coo(m, m, row, col, val))


# name -> TileMatrix from a package (tilespmv_tpu or tilespmv_tpu_torch)
# and its generators. The classes each f32 / f64 plan holds:
MATRICES = {
    # dense + stream / the same
    "mixed": lambda pkg, gen: pkg.tile_create(
        gen.mixed_structure(512, 512, seed=7)),
    # stream / stream
    "powerlaw": lambda pkg, gen: pkg.tile_create(
        gen.power_law(4096, 4096, 12, seed=3)),
    # band / band
    "band": lambda pkg, gen: pkg.tile_create(gen.banded(2048, 2048, 8,
                                                         seed=3)),
    # dense + W96 / dense + stream
    "w96": lambda pkg, gen: pkg.tile_create(gen.block_random(
        2048, 2048, density=0.05, fill=0.33, seed=5)),
    # the split pair stream + stream2 / the same
    "split": lambda pkg, gen: _split(pkg),
    # dense + W16 + residual / dense + residual
    "hyb_residual": lambda pkg, gen: pkg.tile_create(
        gen.power_law(512, 512, 20, seed=14), pkg.TileConfig(**HYB)),
}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "f64": (torch.float64, jnp.float64)}


def _nbytes(*arrays):
    return sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in arrays)


def jax_profile_fields(plan) -> dict:
    """The reference profile_engines' keys, bytes and counts for a JAX
    LanePlan (tilespmv_tpu/utils/profiling.py:83-141)."""
    out = {}
    if plan.dense is not None:
        d = plan.dense
        out["dense"] = dict(bytes=_nbytes(d.val, d.meta),
                            chunks=int(d.val.shape[0]), t_lanes=d.t_lanes)
    if plan.band is not None:
        bd = plan.band
        out["band"] = dict(bytes=_nbytes(bd.val, bd.bloc),
                           chunks=int(bd.val.shape[0]), c_cols=bd.c_cols)
    for s in plan.sparses:
        out[f"sparse_w{s.width}"] = dict(bytes=_nbytes(s.val, s.meta),
                                         chunks=int(s.val.shape[0]),
                                         t_lanes=s.t_lanes)
    for key, st in (("stream", plan.stream), ("stream2", plan.stream2)):
        if st is not None:
            out[key] = dict(bytes=_nbytes(st.val, st.vidx, st.planes),
                            slabs=int(st.nslabs), rounds=st.rounds,
                            s_batch=st.s_batch)
    r = plan.residual
    if r.val.shape[0]:
        out["residual"] = dict(bytes=_nbytes(r.val, r.row, r.col))
    return out


@pytest.fixture
def short_timed(monkeypatch):
    """profile_engines with the difference loops cut to 1 and 3 calls."""
    monkeypatch.setattr(profiling, "_timed", functools.partial(
        profiling._timed, reps=1, k1=1, k2=3))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_profile_engines_matches_reference_plan(name, dtype, short_timed):
    t_dtype, j_dtype = DTYPES[dtype]
    jplan = build_lane_plan(MATRICES[name](jpkg, j_gen),
                            compute_dtype=j_dtype)
    want = jax_profile_fields(jplan)
    op = TileSpMV(MATRICES[name](tpkg, t_gen), device="cpu", dtype=t_dtype)
    before = kernels.launch_counts()
    prof = profiling.profile_engines(op)
    assert kernels.launch_counts() == before
    assert list(prof) == list(want)
    for key, fields in want.items():
        got = prof[key]
        assert got["us"] > 0 and got["gbps"] > 0, key
        assert set(got) == {"us", "gbps", *fields}, key
        for f, v in fields.items():
            if f == "bytes" and dtype == "f64":
                continue
            assert got[f] == v, (key, f)


def test_profile_engines_times_each_class_once_per_call(monkeypatch):
    """Each class is timed through its own wrapper into its own zeroed y,
    on the padded x; the residual on the unpadded x."""
    op = TileSpMV(t_gen.mixed_structure(512, 512, seed=7), device="cpu")
    calls = []

    def fake(fn, *args, **kw):
        y = args[-1]
        assert y.abs().max() == 0 and all(y is not c[-1] for c in calls)
        fn(*args)
        calls.append((fn, *args))
        return 1e-6
    monkeypatch.setattr(profiling, "_timed", fake)
    prof = profiling.profile_engines(op)
    assert len(calls) == len(prof)
    assert all(v["us"] == pytest.approx(1.0) for v in prof.values())
    plan = op.device_plan()
    wrappers = [c[0] for c in calls]
    assert wrappers[0] is kernels.dense_spmv
    assert wrappers.count(kernels.sparse_spmv) == len(plan.sparses)
    # every class added into its y: their sum is y = A @ x
    x = (np.arange(op.shape[1]) % 10) / 4.0
    total = sum(c[-1] for c in calls)[: op.shape[0]]
    torch.testing.assert_close(total, op(x))


def _fake_times(log):
    """A recorder standing in for `_timed`: logs each arm label and
    returns a time drifting with the number of calls so far."""
    base = {"a": 3e-6, "b": 2e-6, "c": 2.5e-6}

    def fake(fn, *args, **kw):
        log.append((fn, args, kw))
        return base[fn] * (1 + 0.01 * len(log))
    return fake


@pytest.mark.parametrize("names", [("a", "b", "c"), ("b",)])
def test_interleaved_ab_matches_reference(names, monkeypatch, capsys):
    arms = {n: (n, f"arg-{n}") for n in names}
    logs, results, printed = [], [], []
    for mod in (j_abtest, abtest):
        log = []
        monkeypatch.setattr(mod, "_timed", _fake_times(log))
        results.append(mod.interleaved_ab(arms, rounds=3, k1=2, k2=5))
        logs.append(log)
        printed.append(capsys.readouterr().out)
    assert logs[0] == logs[1]
    assert [c[0] for c in logs[1]][: 2 * len(names)] == \
        list(names) + list(reversed(names))
    assert logs[1][0][2] == dict(k1=2, k2=5)
    assert results[0] == results[1]
    assert printed[0] == printed[1]
    if len(names) > 1:
        assert results[1]["winner"] == "b"
        assert results[1]["margin"] > 1


def test_spmv_arms_and_build_op_variant():
    csr = t_gen.mixed_structure(512, 512, seed=7)
    op = TileSpMV(csr, device="cpu")
    kinds = [c["kind"] for c in op.summary["classes"]]
    assert "stream" in kinds
    old = lane_plan.STREAM_MIN_ENTRIES
    no_stream = abtest.build_op_variant(csr, lane_plan,
                                        {"STREAM_MIN_ENTRIES": 10 ** 9},
                                        device="cpu")
    assert lane_plan.STREAM_MIN_ENTRIES == old
    assert "stream" not in [c["kind"] for c in no_stream.summary["classes"]]
    f64 = abtest.build_op_variant(csr, lane_plan, {}, device="cpu",
                                  dtype=torch.float64)
    assert f64.dtype == torch.float64
    x = np.linspace(-1, 1, csr.n)
    arms = abtest.spmv_arms({"base": op, "no_stream": no_stream,
                             "f64": f64}, x)
    for name, (fn, xt) in arms.items():
        assert xt.dtype == fn.__self__.dtype
        torch.testing.assert_close(fn(xt).double(),
                                   torch.from_numpy(csr.matvec(x)),
                                   rtol=2e-4, atol=1e-4)
    res = abtest.interleaved_ab(arms, rounds=2, verbose=False, reps=1,
                                k1=1, k2=2)
    assert res["winner"] in arms
    assert all(len(v) == 2 and min(v) > 0
               for v in res["times_us"].values())


def test_trace_context_writes_a_trace(tmp_path):
    op = TileSpMV(t_gen.mixed_structure(512, 512, seed=7), device="cpu")
    x = np.linspace(-1, 1, 512)
    with profiling.trace_context(tmp_path / "trace") as prof:
        op(x)
    assert prof.key_averages()
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]
