"""The microbenchmarks' plain versions against the reference's Pallas
kernels in interpret mode, and their wrappers and scripts on the CPU.

The reference scripts (scripts/microbench_{gather,scatter}.py) are
loaded by path; their `run` draws unseeded inputs and picks no interpret
mode, so each test builds run's pallas_call from the script's own
`make_kernel` and BlockSpecs with grid=(2,) and interpret=True on the
port's seeded inputs. Tolerance: max |plain - Pallas| <= 1e-5 *
max(1, max|Pallas|) (the plain versions sum in another order)."""
import importlib.util
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tilespmv_tpu_torch.ops.cuda import build, kernels, reference
from tilespmv_tpu_torch.scripts import microbench_gather as t_gather
from tilespmv_tpu_torch.scripts import microbench_scatter as t_scatter
from tilespmv_tpu_torch.scripts import (band_probes, dense_probes,
                                        sparse_probes, spmm_probes,
                                        stream_probes)

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
TOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vmem(shape):
    return pl.BlockSpec(shape, lambda i: (0, 0), memory_space=pltpu.VMEM)


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("r", reference.MB_GATHER_R)
def test_gather_plain_matches_pallas(r):
    ref = _script("microbench_gather")
    assert (ref.ROWS_PER_STEP, ref.LANES) == (reference.MB_ROWS,
                                              reference.LANES)
    src, idx = t_gather.inputs(seed=r)
    rows = (ref.ROWS_PER_STEP, ref.LANES)
    f = pl.pallas_call(
        ref.make_kernel(r, ref.ROWS_PER_STEP // r), grid=(2,),
        in_specs=[_vmem(rows)] * 2, out_specs=_vmem((8, ref.LANES)),
        out_shape=jax.ShapeDtypeStruct((8, ref.LANES), jnp.float32),
        interpret=True)
    want = np.asarray(f(src.numpy(), idx.numpy()))
    _close(reference.microbench_gather_reference(src, idx, r), want)
    # the wrapper runs the plain version on CPU tensors, launching nothing
    before = kernels.launch_counts()
    _close(kernels.microbench_gather(src, idx, r, nsteps=3), want)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("arm", reference.MB_SCATTER_ARMS)
def test_scatter_plain_matches_pallas(arm):
    ref = _script("microbench_scatter")
    assert (ref.S, ref.SUBS, ref.LANES, ref.ROUNDS) == (
        reference.MB_SLABS, reference.SUBS, reference.LANES,
        reference.MB_ROUNDS)
    csum, pe = t_scatter.inputs(arm, seed=len(arm))
    rows = max(3 * ref.S * ref.SUBS * ref.ROUNDS, 96 * ref.S)
    assert pe.shape == (rows, ref.LANES) == (reference.MB_PE_ROWS, 128)
    assert int(pe.min()) >= 0 and int(pe.max()) < (
        ref.SUBS if arm == "rounds" else ref.LANES)
    f = pl.pallas_call(
        ref.make_kernel(arm), grid=(2,),
        in_specs=[_vmem((ref.S * ref.SUBS, ref.LANES)),
                  _vmem((rows, ref.LANES))],
        out_specs=_vmem((ref.SUBS, ref.LANES)),
        out_shape=jax.ShapeDtypeStruct((ref.SUBS, ref.LANES), jnp.float32),
        interpret=True)
    want = np.asarray(f(csum.numpy(), pe.numpy()))
    _close(reference.microbench_scatter_reference(arm, csum, pe), want)
    before = kernels.launch_counts()
    _close(kernels.microbench_scatter(arm, csum, pe, nsteps=2), want)
    assert kernels.launch_counts() == before


def test_microbench_wrappers_refuse_bad_inputs():
    src, idx = t_gather.inputs()
    with pytest.raises(ValueError):
        kernels.microbench_gather(src, idx, 12)
    with pytest.raises(TypeError):
        kernels.microbench_gather(src, idx.to(torch.int16), 8)
    with pytest.raises(ValueError):
        kernels.microbench_gather(src[:256], idx, 8)
    with pytest.raises(ValueError):
        kernels.microbench_gather(src, idx, 8, nsteps=0)
    csum, pe = t_scatter.inputs("offs")
    with pytest.raises(ValueError):
        kernels.microbench_scatter("offs_roll", csum, pe)
    with pytest.raises(ValueError):
        kernels.microbench_scatter("offs", csum, pe[:1248])
    with pytest.raises(ValueError):
        kernels.microbench_scatter("offs", csum.to("meta"), pe.to("meta"))


@pytest.mark.parametrize("script,argv", [
    (t_gather, None), (t_scatter, []), (t_scatter, ["rounds"]),
    (stream_probes, None), (dense_probes, None), (band_probes, None),
    (sparse_probes, None), (spmm_probes, None)])
def test_scripts_exit_nonzero_without_cuda(script, argv, monkeypatch,
                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = script.main() if argv is None else script.main(argv)
    assert rc != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_stream_probes_edit_the_kernel_source():
    """Each probe of scripts/stream_probes.py is one edit of stream.cu as
    it stands: the x gather gone (nogather), the segmented scan gone
    (noscan), or both (loads)."""
    src = (build.CSRC_DIR / "stream.cu").read_text()
    out = {name: edit(src) for name, edit in stream_probes.PROBES.items()}
    for name, o in out.items():
        assert o != src and o.count("{") == o.count("}"), name
    gather = "v[u] * x["
    assert gather not in out["nogather"] and gather in out["noscan"]
    assert "__shfl_up_sync" in out["nogather"]
    assert "__shfl_up_sync" not in out["noscan"]
    assert gather not in out["loads"]
    assert "__shfl_up_sync" not in out["loads"]


def test_dense_probes_edit_the_kernel_source():
    """Each copy of scripts/dense_probes.py is dense.cu as it stands with
    the column mask taken as all set (groups), a block per lane group in
    place of the group list (all+mask), or both (all)."""
    src = (build.CSRC_DIR / "dense.cu").read_text()
    out = {arm: edit(src) for arm, edit in dense_probes.EDITS.items()}
    assert tuple(dense_probes.ARMS) == ("groups+mask", *out)
    for arm, o in out.items():
        assert o != src and o.count("{") == o.count("}"), arm
    mask, table = "cmask[(long long)", "groups[blockIdx.x]"
    assert mask in src and table in src
    assert mask not in out["groups"] and table in out["groups"]
    assert mask in out["all+mask"] and table not in out["all+mask"]
    assert mask not in out["all"] and table not in out["all"]


def test_band_probes_edit_the_kernel_source():
    """Each copy of scripts/band_probes.py is band.cu as it stands with
    kRows set in both dtypes (rows1, rows2, rows4), or with the staging
    dropped and x read per lane (lane_x) or from one block (one_x)."""
    src = (build.CSRC_DIR / "band.cu").read_text()
    assert "constexpr int kRows = sizeof(V) == 8 ? " in src
    out = {arm: edit(src) for arm, edit in band_probes.EDITS.items()}
    assert band_probes.ARMS == ("kept", "rows1", "rows2", "rows4",
                                "lane_x", "one_x")
    for arm, o in out.items():
        assert o != src and o.count("{") == o.count("}"), arm
    for r in (1, 2, 4):
        assert f"constexpr int kRows = {r};" in out[f"rows{r}"]
        assert "sizeof(V) == 8 ?" not in out[f"rows{r}"]
    stage = "const int nstage = c_cols * kLanes * kB;"
    for arm in ("lane_x", "one_x"):
        assert stage not in out[arm] and "const V* xl = xs" not in out[arm]
        assert "const int nstage = 0;" in out[arm]
    assert "pbw[loc >> 8]" in out["lane_x"].split("const V* xl =")[-1]
    assert "pbw[0]" in out["one_x"]
    assert band_probes.TIMED_ONLY == ("one_x",)


def test_sparse_probes_edit_the_kernel_source():
    """Each copy of scripts/sparse_probes.py is sparse.cu as it stands
    with kSlots set to 8, 16 or 32 slots a thread, one atomic per (tile,
    row) (tile_atomics), or with a part of its work taken out (empty,
    nox, noflush: timed only); class_tiles counts a class's tiles and
    tile rows."""
    src = (build.CSRC_DIR / "sparse.cu").read_text()
    out = {arm: edit(src) for arm, edit in sparse_probes.EDITS.items()}
    assert sparse_probes.ARMS == ("kept", "slots8", "slots16", "slots32",
                                  "tile_atomics", "empty", "nox",
                                  "noflush")
    assert sparse_probes.TIMED_ONLY == ("empty", "nox", "noflush")
    for arm, o in out.items():
        assert o.count("{") == o.count("}"), arm
    for k in (8, 16, 32):
        assert out[f"slots{k}"].count("constexpr int kSlots = ") == 1
        assert f"constexpr int kSlots = {k};" in out[f"slots{k}"]
    assert "[kLanes * kPad];\n  return;\n" in out["empty"]
    assert "if (false) {\n    int panel" in out["nox"]
    assert "atomicAdd(yw" in out["noflush"]
    assert "if (false && (smask[lane]" in out["noflush"]
    assert "__match_any_sync(" in src
    assert "__match_any_sync(" not in out["tile_atomics"]
    assert "const int lead = l;" in out["tile_atomics"]
    # class_tiles: two steps of one chunk, tile rows 3, 3, 5 and 256 + 3
    meta = torch.full((2, 9, 128), -1, dtype=torch.int32)
    meta[0, 0, :3], meta[0, 1, :3] = 0, torch.tensor([3, 3, 5])
    meta[1, 0, 0], meta[1, 1, 0] = 0, 3
    s = SimpleNamespace(val=torch.zeros(2, 24, 128), meta=meta, c_batch=1,
                        cw=torch.tensor([0, 1]))
    assert sparse_probes.class_tiles(s) == {"tiles": 4, "tile_rows": 3,
                                            "most": 2}


def test_spmm_probes_edit_the_kernel_sources():
    """Each copy of scripts/spmm_probes.py is stream2.cu or
    sparse_spmm.cu as it stands with one or two constants set: the warp
    scan off (noscan), the shared window on (window, window_noscan), the
    products a thread holds (lanes a thread at k = 8: 2 and 4; at k = 16:
    1 and 4), the flush's scalar atomics, the registers capped for 4
    blocks an SM, slots or lanes of a W-class block; or with the runs'
    adds taken out (noadd: timed only); the group and pair arms run the
    kept source."""
    src = (build.CSRC_DIR / "stream2.cu").read_text()
    out = {arm: e(src) for arm, e in spmm_probes.STREAM_EDITS.items()}
    assert spmm_probes.STREAM_ARMS == (
        "kept", "noscan", "window", "window_noscan", "products16",
        "products32", "scalar_atomics", "blocks4", "noadd", "group1",
        "group2", "group4", "group8", "groupS", "pairs")
    assert spmm_probes.STREAM_TIMED_ONLY == ("noadd",)
    assert "constexpr int kScan = 1;" in src
    assert "constexpr int kWindowed = 0;" in src
    assert "constexpr int kScan = 0;" in out["noscan"]
    assert "constexpr int kWindowed = 1;" in out["window"]
    assert "constexpr int kScan = 0;" in out["window_noscan"]
    assert "constexpr int kWindowed = 1;" in out["window_noscan"]
    for p in (16, 32):
        assert f"constexpr int kProducts = {p};" in out[f"products{p}"]
    assert "constexpr int kMinBlocks = 4;" in out["blocks4"]
    assert "r[u] >= 0 && c[u][0] == 1e30f) {" in out["noadd"]
    assert "#define VEC_ATOMICS 0\n" in out["scalar_atomics"]
    for o in out.values():
        assert o != src and o.count("{") == o.count("}")
    assert spmm_probes.kept_products() == 64
    assert [spmm_probes.lanes_per_thread(p, 8) for p in (16, 32, 64)] == [
        2, 4, 4]
    assert [spmm_probes.lanes_per_thread(p, 16) for p in (16, 32, 64)] == [
        1, 2, 4]
    src = (build.CSRC_DIR / "sparse_spmm.cu").read_text()
    out = {arm: e(src) for arm, e in spmm_probes.SPARSE_EDITS.items()}
    assert spmm_probes.SPARSE_ARMS == ("kept", "slots16", "lanes16",
                                       "atomic_rows", "scalar_atomics")
    assert "constexpr int kOwnRows = 0;" in out["atomic_rows"]
    assert "constexpr int kSlots = 16;" in out["slots16"]
    assert "constexpr int kLanes = 16;" in out["lanes16"]
    assert "#define VEC_ATOMICS 1\n" in src
    assert "#define VEC_ATOMICS 0\n" in out["scalar_atomics"]
    for o in out.values():
        assert o != src and o.count("{") == o.count("}")


def test_spmm_probes_edit_the_band_and_dense_sources():
    """Each band and dense copy of scripts/spmm_probes.py is band_spmm.cu
    or dense_spmm.cu as it stands with one constant set (kRows 1, 2, 4;
    every column block staged at once; each thread adding its own rows
    into Y; 4 tile rows a dense block) or one line edited (a block for
    every lane group, every column loaded, scalar atomics)."""
    src = (build.CSRC_DIR / "band_spmm.cu").read_text()
    out = {arm: e(src) for arm, e in spmm_probes.BAND_EDITS.items()}
    assert spmm_probes.BAND_ARMS == ("kept", "rows1", "rows2", "rows4",
                                     "stage_all", "y_adds")
    for c in ("kRows = K <= 8 ? 4 : 2;", "kStages = 2;", "kYShared = 1;"):
        assert f"constexpr int {c}" in src
    for r in (1, 2, 4):
        assert f"constexpr int kRows = {r};" in out[f"rows{r}"]
    assert "constexpr int kStages = 8;" in out["stage_all"]
    assert "constexpr int kYShared = 0;" in out["y_adds"]
    for arm, o in out.items():
        assert o.count("{") == o.count("}"), arm
    src = (build.CSRC_DIR / "dense_spmm.cu").read_text()
    out = {arm: e(src) for arm, e in spmm_probes.DENSE_EDITS.items()}
    assert spmm_probes.DENSE_ARMS == ("kept", "all_groups", "all_columns",
                                      "scalar_atomics", "warps4")
    assert "constexpr int kWarps = 8;" in src
    assert "constexpr int kWarps = 4;" in out["warps4"]
    mask, table = "cmask[(long long)", "groups[blockIdx.x]"
    assert mask in src and table in src
    assert table not in out["all_groups"] and mask in out["all_groups"]
    assert mask not in out["all_columns"] and table in out["all_columns"]
    assert "#define VEC_ATOMICS 0\n" in out["scalar_atomics"]
    for arm, o in out.items():
        assert o != src and o.count("{") == o.count("}"), arm


def test_edit_const_sets_the_one_definition():
    """build.edit_const rewrites `constexpr int <name> = ...;` whatever it
    holds, and refuses a source that defines the name never or twice."""
    src = ("template <typename V>\nconstexpr int kRows = sizeof(V) == 8 ? "
           "1 : 2;\nconstexpr int kRowsMax = 4;\n")
    got = build.edit_const(src, "kRows", 4)
    assert got == ("template <typename V>\nconstexpr int kRows = 4;\n"
                   "constexpr int kRowsMax = 4;\n")
    with pytest.raises(RuntimeError):
        build.edit_const(src, "kSlots", 8)
    with pytest.raises(RuntimeError):
        build.edit_const(src + src, "kRows", 4)


def test_ab_arms_checks_then_times_in_turns(monkeypatch):
    """utils.profiling.ab_arms on the CPU with the card's calls stubbed:
    every arm but the timed-only ones is held to the plain version's y
    (an arm past the tolerance raises, naming it), then the arms are
    timed forward then backward, `rounds` times, each its median."""
    from tilespmv_tpu_torch.utils import profiling
    want = torch.tensor([1.0, 2.0, 3.0])
    adds = {"a": want, "b": want + 1e-7, "wrong": -want, "bad": want + 1}
    timed = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def graph_ms(fn):
        fn()
        timed.append(fn.arm)
        return {"a": 1.0, "b": 2.0, "wrong": 0.5}[fn.arm] + len(timed)
    monkeypatch.setattr(profiling, "graph_ms", graph_ms)

    def make_run(arm, y):
        def run():
            y.add_(adds[arm])
        run.arm = arm
        return run
    out = profiling.ab_arms(make_run, ("a", "b", "wrong"), want, 1e-5,
                            timed_only=("wrong",), rounds=2)
    assert timed == ["a", "b", "wrong", "wrong", "b", "a"] * 2
    assert out["a"]["err"] == 0.0 and out["b"]["err"] < 1e-6
    assert out["wrong"]["err"] is None
    # a: 1 + {1, 6, 7, 12}; b: 2 + {2, 5, 8, 11}
    assert out["a"] == {"err": 0.0, "ms": 7.5, "min_ms": 2.0,
                        "max_ms": 13.0}
    assert (out["b"]["min_ms"], out["b"]["max_ms"]) == (4.0, 13.0)
    with pytest.raises(AssertionError, match="probe arm bad"):
        profiling.ab_arms(make_run, ("a", "bad"), want, 1e-5, name="probe")
