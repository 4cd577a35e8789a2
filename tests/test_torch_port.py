"""Structural guarantees of the port: tilespmv_tpu_torch never imports
JAX or tilespmv_tpu; a class wrapper runs its plain version only for
CPU tensors and otherwise launches its kernel or raises; a failed CUDA
build raises; the native host library is built into the port's own
build directory."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from tilespmv_tpu_torch.core import native
from tilespmv_tpu_torch.io import generate
from tilespmv_tpu_torch.ops.cuda import build, kernels, reference
from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan
from tilespmv_tpu_torch.core.convert import tile_create

PKG = pathlib.Path(__file__).resolve().parents[1] / "tilespmv_tpu_torch"
ROOT = PKG.parent


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tilespmv_tpu"), (path, mod)


def _plan():
    csr = generate.mixed_structure(512, 512, seed=1)
    return reference.to_torch(build_lane_plan(tile_create(csr)))


def test_wrappers_use_plain_version_on_cpu():
    plan = _plan()
    x = torch.from_numpy(np.linspace(-1, 1, 512).astype(np.float32))
    xp = reference.pad_x(plan, x)
    before = kernels.launch_counts()
    for wrap, plain, cls in (
            (kernels.dense_spmv, reference.dense_reference, plan.dense),
            (kernels.stream_spmv, reference.stream_reference,
             plan.stream)):
        ya = torch.zeros(plan.y_padded_len)
        yb = torch.zeros(plan.y_padded_len)
        assert wrap(cls, xp, ya) is ya
        plain(cls, xp, yb)
        assert torch.equal(ya, yb)
    assert kernels.launch_counts() == before
    torch.testing.assert_close(kernels.spmv_cuda(plan, x),
                               reference.spmv_reference(plan, x))


def test_wrapper_refuses_other_devices_and_bad_inputs():
    plan = _plan()
    xp = torch.zeros(max(plan.x_padded_len, plan.x_padded_len128),
                     device="meta")
    y = torch.zeros(plan.y_padded_len, device="meta")
    meta_dense = type(plan.dense)(**{
        **plan.dense.__dict__,
        **{k: v.to("meta") for k, v in plan.dense.__dict__.items()
           if isinstance(v, torch.Tensor)}})
    with pytest.raises(ValueError):
        kernels.dense_spmv(meta_dense, xp, y)
    xc = torch.zeros(xp.shape[0])
    with pytest.raises(TypeError):
        kernels.dense_spmv(plan.dense, xc, torch.zeros(10,
                                                       dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.dense_spmv(plan.dense, xc, y)   # x and y on two devices


def test_cuda_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setenv("NVCC", str(tmp_path / "missing-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: str(p).startswith(str(tmp_path)) and
                        pathlib.Path(p).exists())
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load()
    # a compiler that runs and fails raises too, with its output
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.load()
    assert not (tmp_path / "cuda" / build.LIB_NAME).exists()


def test_native_library_builds_in_port_build_dir():
    assert "-march=native" not in native.CXXFLAGS
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain here")
    assert native._LIB_PATH.parent == ROOT / "build" / "native"
    assert native._LIB_PATH.exists()
