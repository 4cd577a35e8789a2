"""plan_mb: the bytes of the cell's plan that one call streams, in MB
(1e6 bytes): each class's values and their indices, as its kernel reads
them (the stream classes' entry rows, not their round planes), summed
over every class, x and y left out, from the program's census
(`tilespmv_tpu_torch.spans.plan_census()`). None for a program without
the census."""


def read(rec):
    try:
        from tilespmv_tpu_torch import spans
    except ImportError:
        return None
    census = getattr(spans, "plan_census", None)
    census = None if census is None else census()
    if not census:
        return None
    return sum(c["bytes"] for c in census.values()) / 1e6
