"""GAP's kron graph: a Graph500 Kronecker graph, undirected.

As GAP's generator (MakeKronEL in src/generator.h) makes it:
2**scale * degree edges, each endpoint pair chosen bit by bit from one
uniform draw a level (A, B, C of the quadrants; D the rest), the vertex
ids then permuted at random. GAP's builder then makes the graph
undirected (each edge both ways) and drops self-loops and duplicate
edges. Each undirected edge gets one value drawn from the seed,
(k + 1) / 4 with k uniform in 0..9, in both of its entries (GAP's
PageRank would weigh by 1/degree; the configuration lists this under
`assumed`).
"""
import torch


def generate(cfg: dict, gen: torch.Generator, device, dtype: torch.dtype):
    """(m, n, indptr int64, indices int32, data `dtype`) on `device`."""
    scale = cfg["scale"]
    nv = 1 << scale
    ne = nv * cfg["degree"]
    a, b, c = cfg["A"], cfg["B"], cfg["C"]
    src = torch.zeros(ne, dtype=torch.int64, device=device)
    dst = torch.zeros(ne, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand(ne, generator=gen, device=device)
        top = r < a + b
        src = 2 * src + (~top)
        dst = 2 * dst + torch.where(top, r > a, r > a + b + c)
    perm = torch.randperm(nv, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    del src, dst, keep
    key = torch.unique(lo * nv + hi)
    lo, hi = key // nv, key % nv
    del key
    val = ((torch.randint(0, 10, (lo.numel(),), generator=gen,
                          device=device) + 1).to(torch.float64) / 4
           ).to(dtype)
    rows = torch.cat([lo, hi])
    cols = torch.cat([hi, lo])
    order = torch.argsort(rows * nv + cols)
    rows, cols, val = rows[order], cols[order], torch.cat([val, val])[order]
    indptr = torch.zeros(nv + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=nv), 0)
    return nv, nv, indptr, cols.to(torch.int32), val
