"""The least time one H100 SXM could take for Y = A @ X.

The work is counted from the matrix and X alone, so it reads the same
whatever plan or kernel computes it: the values read once (nnz values),
X read once (n rows), Y written once (m rows), no index bytes (a
structured layout need not read any), and 2 flops a nonzero and column.
The floor is the larger of the bytes over the peak HBM bandwidth and
the flops over the peak rate of the dtype the sums are taken in.
Peaks: NVIDIA's H100 SXM data sheet (dense, outside the tensor cores),
at the card's full 700 W.
"""
HBM_BYTES_PER_S = 3.35e12
# flops a second by value dtype; bf16 values are summed in float32
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
VALUE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}


def floor_ms(nnz: int, m: int, n: int, k: int, dtype: str) -> dict:
    """{"ms", "bytes", "flops", "by"} of one product with k columns."""
    vb = VALUE_BYTES[dtype]
    nbytes = nnz * vb + (n + m) * vb * k
    flops = 2 * nnz * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return {"ms": max(t_bytes, t_flops) * 1e3, "bytes": nbytes,
            "flops": flops, "by": "bytes" if t_bytes >= t_flops else "flops"}
