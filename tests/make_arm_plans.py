"""Writes tests/fixtures/arm_plans/: lane plans that tilespmv_tpu builds
under the planner arms tilespmv_tpu_torch loads but does not build (the
offs and roll stream scatter encodings, STREAM_SCATTER; the prefix route
of the dense and W-classes, DENSE_ROUTE), each in tilespmv_tpu's own
file layout (its core/serialize.save_lane_plan), stored deflated
(np.savez_compressed of the same arrays; np.load reads either), and a
manifest.json naming each file's matrix, arm and dtype.

The port's card tests (tests/test_torch_cuda.py) and chip_smoke.py's
phase 15 run these files on the card, where there is no JAX; the CPU
tests (tests/test_torch_serialize.py) check that each file still holds
what the reference writes. Run from the repo root, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_arm_plans.py
"""
import json
import os
import pathlib
import tempfile

import numpy as np

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "arm_plans"
MANIFEST = FIXTURES / "manifest.json"
# (file, arm, dtype, (generator function, args, kwargs)): the reference's
# own test matrix of the encodings (tests/test_stream.py; a stream
# class), mixed_medium (a dense class, a W24 class and a stream) and a
# W96 matrix (tests/test_torch_cuda.py's "w96")
POWER_LAW = ("power_law", [2048, 2048, 10], {"seed": 6})
SPECS = [
    ("power_law_offs_f32.npz", "offs", "f32", POWER_LAW),
    ("power_law_roll_f32.npz", "roll", "f32", POWER_LAW),
    ("power_law_offs_f64.npz", "offs", "f64", POWER_LAW),
    ("power_law_roll_f64.npz", "roll", "f64", POWER_LAW),
    ("mixed_medium_prefix_f32.npz", "prefix", "f32",
     ("get_matrix", ["mixed_medium"], {})),
    ("w96_prefix_f32.npz", "prefix", "f32",
     ("block_random", [2048, 2048], {"density": 0.05, "fill": 0.33,
                                     "seed": 5})),
]
DTYPES = {"f32": np.float32, "f64": np.float64}


def matrix(gen, spec):
    """The CSR of a manifest entry's matrix from the generator module
    `gen` (either package's io.generate)."""
    fn, args, kw = spec["matrix"]
    return getattr(gen, fn)(*args, **kw)


def entries() -> list:
    return [dict(file=f, arm=arm, dtype=dt, matrix=list(mat))
            for f, arm, dt, mat in SPECS]


def reference_plan(spec):
    """tilespmv_tpu's lane plan of a manifest entry, built with its knob
    set to the entry's arm."""
    from tilespmv_tpu.core import convert
    from tilespmv_tpu.io import generate
    from tilespmv_tpu.ops.pallas import lane_plan, stream_plan
    module, knob = ((lane_plan, "DENSE_ROUTE") if spec["arm"] == "prefix"
                    else (stream_plan, "STREAM_SCATTER"))
    old = getattr(module, knob)
    setattr(module, knob, spec["arm"])
    try:
        return lane_plan.build_lane_plan(
            convert.tile_create(matrix(generate, spec)),
            compute_dtype=DTYPES[spec["dtype"]])
    finally:
        setattr(module, knob, old)


def reference_arrays(spec) -> dict:
    """The arrays of the file tilespmv_tpu's save_lane_plan writes for a
    manifest entry."""
    from tilespmv_tpu.core import serialize
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plan.npz")
        serialize.save_lane_plan(path, reference_plan(spec))
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def main() -> None:
    import jax
    jax.config.update("jax_enable_x64", True)
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for spec in entries():
        np.savez_compressed(FIXTURES / spec["file"],
                            **reference_arrays(spec))
        print(spec["file"], (FIXTURES / spec["file"]).stat().st_size)
    MANIFEST.write_text(json.dumps(entries(), indent=1) + "\n")


if __name__ == "__main__":
    main()
