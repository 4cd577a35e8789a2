"""Builds the native libraries once before a test session over `tests/`.

The reference's `native/libtileconv.so` (`make -C native`, what
tilespmv_tpu.core.native runs at first use) and the port's
`build/native/libtileconv.so` are otherwise built by whichever test
first imports them. Under `-n` every xdist worker collects every file,
so each can run `make` on the same library at once, and a worker that
loads a half-written library skips tests/test_native.py whole. Here only
the controller builds (an xdist worker has `workerinput`), serially and
under a timeout, before the workers start; where a build fails, the
modules' own fallbacks stand. Sessions that collect nothing under
`tests/` (the benchmark's own tests) build nothing.
"""
import pathlib
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent
TESTS = ROOT / "tests"


def _collects_tests(config) -> bool:
    here = pathlib.Path(config.invocation_params.dir)
    args = [a.split("::")[0] for a in config.args] or ["tests"]
    for a in args:
        p = (here / a).resolve()
        if p == TESTS or TESTS in p.parents or p == ROOT:
            return True
    return False


def pytest_configure(config):
    if hasattr(config, "workerinput") or not _collects_tests(config):
        return
    try:
        subprocess.run(["make", "-C", str(ROOT / "native")],
                       capture_output=True, timeout=600, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
    from tilespmv_tpu_torch.core import native
    native.get_lib()
