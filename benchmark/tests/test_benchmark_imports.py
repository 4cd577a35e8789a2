"""Nothing the benchmark runs imports JAX or tilespmv_tpu, compared by
whole top-level name; the reference imports nothing of the program."""
import ast

from benchmark import harness

SOURCES = sorted(harness.HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_nor_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_and_floor_import_nothing_of_the_program():
    for stem in ("reference", "floor", "timeline", "readers"):
        for name in _imports(harness.HERE / f"{stem}.py"):
            assert not name.startswith("tilespmv_tpu"), (stem, name)


def test_forbidden_modules_compares_whole_names():
    mods = ["tilespmv_tpu_torch", "tilespmv_tpu_torch.ops.spmv", "jaxtyping",
            "numpy", "flaxen"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "tilespmv_tpu",
                                             "tilespmv_tpu.ops", "flax",
                                             "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "tilespmv_tpu", "tilespmv_tpu.ops"]
