"""w_fill_pct: the W-classes' nonzeros over their value slots, in %, from
the program's census of the cell's plan
(`tilespmv_tpu_torch.spans.plan_census()`): the share of what sparse.cu
streams that is not padding. None for a program without the census or a
plan without a W-class (kinds `w<W>`)."""


def read(rec):
    try:
        from tilespmv_tpu_torch import spans
    except ImportError:
        return None
    census = getattr(spans, "plan_census", None)
    census = None if census is None else census()
    if not census:
        return None
    w = [c for kind, c in census.items()
         if kind[:1] == "w" and kind[1:].isdigit()]
    slots = sum(c["slots"] for c in w)
    return 100.0 * sum(c["nnz"] for c in w) / slots if slots else None
