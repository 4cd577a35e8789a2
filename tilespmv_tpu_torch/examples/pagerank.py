"""PageRank over a power-law graph with the stream engine.

Port of examples/pagerank.py: the same graph and seed. The adjacency
matrix of a power-law graph converts to near-singleton 16x16 tiles, the
case the entry-level stream class exists for (ops/cuda/stream_plan.py).
The power iteration is plain torch on the operator's device: each step
is one SpMV plus elementwise work.

    python -m tilespmv_tpu_torch.examples.pagerank      # on the card
"""
import numpy as np
import torch

from ..io import generate
from ..io.mmio import csr_from_coo
from ..ops.spmv import TileSpMV


def column_stochastic(csr):
    """Scale columns to sum to 1 (dangling columns stay zero)."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    colsum = np.zeros(csr.n)
    np.add.at(colsum, csr.indices, csr.data)
    scale = np.where(colsum > 0, 1.0 / np.maximum(colsum, 1e-300), 0.0)
    vals = csr.data * scale[csr.indices]
    return csr_from_coo(csr.m, csr.n, rows, csr.indices.astype(np.int64),
                        vals)


def pagerank(op: TileSpMV, damping: float = 0.85, iters: int = 50):
    """`iters` damped power steps from the uniform vector."""
    n = op.shape[1]
    base = torch.full((n,), (1.0 - damping) / n, dtype=torch.float32,
                      device=op.device)
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=op.device)
    for _ in range(iters):
        r2 = damping * op(r) + base
        # dangling mass redistributed uniformly
        r = r2 + (1.0 - torch.sum(r2)) / n
    return r


def main(device=None):
    """PageRank of the seeded power-law graph on `device` (None: the
    card); returns the max abs error against a dense power iteration."""
    g = generate.power_law(4096, 4096, avg_nnz_per_row=12, seed=7)
    a = column_stochastic(g)
    op = TileSpMV(a, device=device)
    r = pagerank(op).cpu().numpy()
    top = np.argsort(r)[::-1][:5]
    print(f"PageRank: n={a.n} nnz={a.nnz} sum={r.sum():.6f} "
          f"top5={top.tolist()}")
    # golden check against dense power iteration
    d = a.to_dense()
    x = np.full(a.n, 1.0 / a.n)
    for _ in range(50):
        x2 = 0.85 * d @ x + 0.15 / a.n
        x = x2 + (1.0 - x2.sum()) / a.n
    err = np.max(np.abs(r - x))
    print(f"max abs err vs dense power iteration: {err:.2e}")
    return err


if __name__ == "__main__":
    main()
