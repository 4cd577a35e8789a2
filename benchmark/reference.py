"""The plain reference: y = A @ x in float64 with NumPy, from the CSR
arrays that the benchmark made and handed to the program too.

It imports nothing of the program and takes nothing the program made
(no plan, no operator). `product` also returns |A| @ |x|, the scale that
`gap` measures each row's difference against. Blocks of rows run on a
few threads (NumPy's gathers and sums release the interpreter lock);
each row is summed in column order within one block, so the result does
not depend on the threads.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# nonzeros a block of rows holds (bounds the gather temporaries)
BLOCK_NNZ = 1 << 21
THREADS = min(8, os.cpu_count() or 1)


def product(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
            x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(A @ x, |A| @ |x|) in float64, for x (n,) or (n, k)."""
    x = np.asarray(x, dtype=np.float64)
    cols = np.ascontiguousarray(x.reshape(x.shape[0], -1).T)
    vals = np.asarray(data, dtype=np.float64)
    m = indptr.size - 1
    y = np.zeros((cols.shape[0], m))
    s = np.zeros_like(y)
    cuts = np.searchsorted(indptr, np.arange(BLOCK_NNZ, indptr[-1],
                                             BLOCK_NNZ))
    bounds = np.unique(np.concatenate([[0], cuts, [m]]))

    def block(b: int) -> None:
        r0, r1 = int(bounds[b]), int(bounds[b + 1])
        lo, hi = int(indptr[r0]), int(indptr[r1])
        if hi == lo:
            return
        full = np.diff(indptr[r0:r1 + 1]) > 0
        starts = (indptr[r0:r1] - lo)[full]
        v, idx = vals[lo:hi], indices[lo:hi]
        for c, xc in enumerate(cols):
            p = v * xc[idx]
            y[c, r0:r1][full] = np.add.reduceat(p, starts)
            s[c, r0:r1][full] = np.add.reduceat(np.abs(p), starts)

    with ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(block, range(bounds.size - 1)))
    return y.T.reshape((m,) + x.shape[1:]), s.T.reshape((m,) + x.shape[1:])


def gap(y: np.ndarray, want: np.ndarray, scale: np.ndarray) -> float:
    """The largest |y - want| / (|A| @ |x|) over all entries: the error
    of each row against what the row's own magnitudes allow. A row whose
    scale is 0 has to be 0 exactly; a non-finite y reads inf."""
    y = np.asarray(y, dtype=np.float64)
    diff = np.abs(y - want)
    bad = ~np.isfinite(y) | ((scale == 0) & (diff != 0))
    if bad.any():
        return float("inf")
    rel = np.divide(diff, scale, out=np.zeros_like(diff), where=scale > 0)
    return float(rel.max()) if rel.size else 0.0
