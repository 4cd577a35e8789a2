"""state_builds: call states the program built in the run's process
(`tilespmv_tpu_torch.spans.state_builds()`): one for the cell's
operator, built at its first call; more are calls that found no state.
None for a program without the counter."""


def read(rec):
    try:
        from tilespmv_tpu_torch import spans
    except ImportError:
        return None
    count = getattr(spans, "state_builds", None)
    return None if count is None else count()
