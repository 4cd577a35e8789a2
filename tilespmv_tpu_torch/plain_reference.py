"""The plain product y = A @ x of a CSR matrix, in float64.

`csr_matvec` is independent of the tiled path: it reads the CSR arrays
as given, with no tiles, classes, plans or kernels, and imports nothing
of this package, so a fault there cannot reach it. It takes one gather,
one multiply and one `index_add_` in plain torch, which adds each row's
products in the order of its entries. `CSRMatrix.matvec` is this product
in the dtype of the matrix and x. The benchmark keeps its own NumPy copy
of the same product (`benchmark/reference.py`), from its own CSR, for
the check that decides `correct`.
"""
import torch


def csr_matvec(indptr, indices, data, x,
               dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """y = A @ x on the CPU for the m x n CSR matrix A (`indptr` (m + 1,),
    `indices` (nnz,), `data` (nnz,)) and x (n,) or X (n, k); arrays or
    tensors of any real dtype, cast to `dtype` (float64 by default)
    before any product."""
    indptr = torch.as_tensor(indptr).cpu().long()
    indices = torch.as_tensor(indices).cpu().long()
    data = torch.as_tensor(data).cpu().to(dtype)
    x = torch.as_tensor(x).cpu().to(dtype)
    m = indptr.numel() - 1
    nnz = int(indptr[-1])
    rows = torch.repeat_interleave(torch.arange(m), indptr.diff())
    prod = x[indices[:nnz]]
    prod *= data[:nnz].reshape((nnz,) + (1,) * (x.dim() - 1))
    y = torch.zeros((m,) + tuple(x.shape[1:]), dtype=dtype)
    return y.index_add_(0, rows, prod)
