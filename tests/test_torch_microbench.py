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

from tilespmv_tpu_torch.io import generate
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


@pytest.mark.parametrize("script,variants,units,cluster", [
    (t_gather, reference.MB_GATHER_R, 66, 2),
    (t_scatter, ("rounds",), 66, 2),
    (t_scatter, ("offs", "offs_nodep", "offs_noroll"), 132, 1)])
def test_timeit_steps_are_whole_multiples_of_the_grid(
        script, variants, units, cluster, monkeypatch, capsys):
    """Each script's `timeit` on the CPU with the card's calls stubbed:
    it times by `step_time` over WAVES[0] and WAVES[1] steps a unit of
    `kernels.microbench_grid`'s G (whole multiples of G, so every unit
    runs the same number of steps), and prints its per-R / per-arm line
    with the shared-memory floor of the variant's wavefronts."""
    from tilespmv_tpu_torch.utils import profiling
    asked, counts, floors = [], [], []
    monkeypatch.setattr(
        kernels, "microbench_grid",
        lambda name, v: asked.append((name, v)) or (units, cluster))

    def step_time(launch, n1, n2):
        counts.append((n1, n2))
        assert tuple(launch(1).shape) == (8, 128)   # the plain version
        return 40e-9
    monkeypatch.setattr(script, "step_time", step_time)
    monkeypatch.setattr(script, "shared_floor_ns",
                        lambda w, dev: floors.append(w) or 20.0)
    for v in variants:
        args = t_gather.inputs() if script is t_gather else (
            t_scatter.inputs(v))
        assert script.timeit(v, *args) == pytest.approx(40.0)
        assert floors[-1] == script.wavefronts(v, args[1])
    name = "microbench_gather" if script is t_gather else (
        "microbench_scatter")
    assert asked == [(name, v) for v in variants]
    assert counts == [(script.WAVES[0] * units, script.WAVES[1] * units)
                      ] * len(variants)
    assert script.WAVES[0] < script.WAVES[1]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(variants)
    for v, line in zip(variants, lines):
        if script is t_gather:
            assert line.startswith(f"R={v:3d}:   40.000 ns/step")
        else:
            assert line.startswith(f"{v:12s}:   3.077 ns/slab")
        assert f"G={units} " in line and f"of {cluster}" in line
        assert "floor" in line and "wavefronts" in line


def test_bank_wavefronts_counts_distinct_words_a_bank():
    """profiling.bank_wavefronts: a warp's load takes as many wavefronts
    as the most distinct words in one bank; lanes on one word share it."""
    from tilespmv_tpu_torch.utils.profiling import bank_wavefronts
    lanes = np.arange(32)
    got = bank_wavefronts(np.stack([
        lanes, np.zeros(32), lanes * 32, (lanes % 4) * 32,
        lanes // 4 + 1000, 7 + 128 * (lanes % 3)]))
    assert got.tolist() == [1, 1, 32, 4, 1, 3]
    assert bank_wavefronts(np.zeros((2, 3, 32))).shape == (2, 3)


def test_wavefronts_follow_the_kernels_walk():
    """The scripts' per-step wavefront counts: with every index 0 each
    load is one wavefront, so the counts are the kernels' loads (gather:
    512 rows x 4 warps of gathers, 64 warps x 32 / (R / 8) index loads,
    two at R = 64, and 64 for the partial; scatter rounds: 8 rounds x 13
    slabs x 32 warps x 5 loads and 64; offs: 13 slabs x 32 warps x (21
    or 16)); on the seeded inputs a gather of 32 random columns of a row
    takes 2.6-3.0 wavefronts on average."""
    src, idx = t_gather.inputs()
    zero = torch.zeros_like(idx)
    for r, loads in zip(reference.MB_GATHER_R, (2048, 1024, 512, 512)):
        assert t_gather.wavefronts(r, zero) == 2048 + loads + 64
    spare = t_gather.wavefronts(32, idx) - 512 - 64
    assert 2.6 < spare / 2048 < 3.0
    assert t_gather.wavefronts(8, idx) - t_gather.wavefronts(16, idx) == 1024
    pe = torch.zeros((reference.MB_PE_ROWS, 128), dtype=torch.int8)
    want = {"rounds": 8 * 13 * 32 * 5 + 64, "offs": 13 * 32 * 21,
            "offs_nodep": 13 * 32 * 16, "offs_noroll": 13 * 32 * 21}
    for arm, w in want.items():
        assert t_scatter.wavefronts(arm, pe) == w
        assert t_scatter.wavefronts(arm, t_scatter.inputs(arm)[1]) > w


def test_microbench_grid_refuses_unknown_variants():
    for name, v in (("microbench_gather", 12),
                    ("microbench_scatter", "offs_roll"),
                    ("microbench_stream", 8)):
        with pytest.raises(ValueError):
            kernels.microbench_grid(name, v)


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
    with kRowGroups set to 4, 2 or 1 (4, 8 or 16 rows a thread), the
    ring cut to 1 or 2 stages or widened to 3 blocks an SM, one atomic
    per (tile, 4 rows) (tile_atomics), or with a part of its work taken
    out (empty, nox, noflush, nocompute: timed only); class_tiles counts
    a class's tiles and tile rows."""
    src = (build.CSRC_DIR / "sparse.cu").read_text()
    out = {arm: edit(src) for arm, edit in sparse_probes.EDITS.items()}
    assert sparse_probes.ARMS == ("kept", "rows4", "rows8", "rows16",
                                  "stages1", "stages2", "blocks3",
                                  "tile_atomics", "empty", "nox",
                                  "noflush", "nocompute")
    assert sparse_probes.TIMED_ONLY == ("empty", "nox", "noflush",
                                        "nocompute")
    for arm, o in out.items():
        assert o.count("{") == o.count("}"), arm
    for rows in (4, 8, 16):
        o = out[f"rows{rows}"]
        assert o.count("constexpr int kRowGroups = ") == 1
        assert f"constexpr int kRowGroups = {16 // rows};" in o
    assert out["rows4"] == src
    for n in (1, 2):
        assert out[f"stages{n}"].count("constexpr int kMaxStages = ") == 1
        assert f"constexpr int kMaxStages = {n};" in out[f"stages{n}"]
    assert "constexpr int kMaxBlocks = 3;" in out["blocks3"]
    assert "unsigned char smem[];\n  return;\n" in out["empty"]
    assert "if (false) {\n    const float* xg" in out["nox"]
    assert "atomicAdd(reinterpret_cast<float4*>(" in out["noflush"]
    assert "if (true) continue;\n" in out["noflush"]
    assert "if (!bits) continue;\n" not in out["noflush"]
    slots = "for (int s = lo; s <= end[i]; ++s) {"
    assert slots in src and slots not in out["nocompute"]
    assert "for (int s = lo; false; ++s) {" in out["nocompute"]
    assert "__match_any_sync(" in src
    assert "__match_any_sync(" not in out["tile_atomics"]
    assert "const unsigned members = 1u << lane;" in out["tile_atomics"]
    # class_tiles: two steps of one chunk, tile rows 3, 3, 5 and 256 + 3
    meta = torch.full((2, 9, 128), -1, dtype=torch.int32)
    meta[0, 0, :3], meta[0, 1, :3] = 0, torch.tensor([3, 3, 5])
    meta[1, 0, 0], meta[1, 1, 0] = 0, 3
    s = SimpleNamespace(val=torch.zeros(2, 24, 128), meta=meta, c_batch=1,
                        cw=torch.tensor([0, 1]))
    assert sparse_probes.class_tiles(s) == {"tiles": 4, "tile_rows": 3,
                                            "most": 2}


def test_sparse_probes_matrices():
    """scripts/sparse_probes.py's matrices: mixed_large by its corpus
    name, hpcg<N> as HPCG's 27-point stencil on an N^3 grid in f32; any
    other name raises."""
    got = sparse_probes.matrix("hpcg5")
    want = generate.stencil_27(5, 5, 5, seed=0, dtype=np.float32)
    assert got.shape == (125, 125) and got.data.dtype == np.float32
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert sparse_probes.DEFAULT == ("mixed_large",)
    assert set(sparse_probes.MATRICES) == {"mixed_large"}
    for bad in ("hpcg", "hpcgx", "mixed"):
        with pytest.raises(KeyError):
            sparse_probes.matrix(bad)


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
