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
from tilespmv_tpu_torch.scripts import dense_probes, stream_probes

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
    (stream_probes, None), (dense_probes, None)])
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
