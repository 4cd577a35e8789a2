"""Conjugate-gradient solve with TileSpMV as the operator.

Port of examples/cg.py: the same SPD system and seed; the iteration is
plain torch on the operator's device, so on the card every step is one
SpMV and a few vector operations with no transfer to the host.

    python -m tilespmv_tpu_torch.examples.cg            # on the card
"""
import numpy as np
import torch

from ..io import generate
from ..io.mmio import CSRMatrix, csr_from_coo
from ..ops.spmv import TileSpMV


def make_spd(n: int = 4096, seed: int = 0) -> CSRMatrix:
    """Sparse SPD system: A = L + L^T + diag shift (banded + noise)."""
    base = generate.banded(n, n, bandwidth=4, seed=seed)
    rows = np.repeat(np.arange(n), np.diff(base.indptr))
    cols = base.indices.astype(np.int64)
    vals = base.data
    # symmetrize and diagonally dominate
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 25.0)])
    return csr_from_coo(n, n, r, c, v)


def cg(op: TileSpMV, b: torch.Tensor, iters: int = 200):
    """Plain CG from x = 0 for `iters` steps; returns (x, |r|)."""
    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = op(p)
        alpha = rs / torch.maximum(torch.dot(p, ap), tiny)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.maximum(rs, tiny)) * p
        rs = rs_new
    return x, torch.sqrt(torch.dot(r, r))


def main(device=None):
    """Solves make_spd()'s system on `device` (None: the card) and
    returns the relative error of x."""
    csr = make_spd()
    op = TileSpMV(csr, device=device)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(csr.n).astype(np.float32)
    b = torch.as_tensor(csr.matvec(x_true.astype(np.float64)),
                        dtype=torch.float32, device=op.device)
    x, rnorm = cg(op, b, iters=200)
    x = x.cpu().numpy()
    err = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    print(f"CG: n={csr.n} nnz={csr.nnz} residual={float(rnorm):.3e} "
          f"relative error={err:.3e}")
    return err


if __name__ == "__main__":
    main()
