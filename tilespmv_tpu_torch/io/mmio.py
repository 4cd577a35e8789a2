"""Matrix Market (.mtx) loader producing CSR.

Feature-parity rewrite of the reference's NIST mmio parser + high-level
loader (reference: src/mmio.h, src/mmio_highlevel.h:593-760 `mmio_allinone`):

* banner parsing with object/format/field/symmetry validation,
* coordinate files of field real / integer / pattern / complex
  (complex keeps the real part, pattern reads value 1.0 — matching
  mmio_highlevel.h:648-676),
* 1-based -> 0-based index adjustment,
* symmetric / hermitian expansion mirroring every off-diagonal entry
  (mmio_highlevel.h:687-731); skew-symmetric additionally negates the
  mirror (an extension — the reference leaves skew files unexpanded),
* histogram + exclusive scan + scatter into CSR.

Differences from the reference (deliberate, documented):
* columns are sorted within each row and duplicate entries are summed
  (canonical CSR). The reference keeps file order and duplicates, which
  makes its dense-tile fill order-sensitive (csr2tile.h:549-567 overwrites
  on duplicates).
* `array` (dense) Matrix Market files are also accepted.

Implemented with NumPy bulk parsing rather than a per-line fscanf loop.
"""
from __future__ import annotations

import dataclasses
import gzip
import io as _io
from typing import Union

import numpy as np

_VALID_OBJECTS = ("matrix",)
_VALID_FORMATS = ("coordinate", "array")
_VALID_FIELDS = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


class MatrixMarketError(ValueError):
    pass


@dataclasses.dataclass
class CSRMatrix:
    """Canonical CSR container (the loader's output and converter's input)."""

    shape: tuple[int, int]
    indptr: np.ndarray  # int64, len m+1
    indices: np.ndarray  # int32, len nnz, sorted within rows
    data: np.ndarray  # value_dtype, len nnz
    is_symmetric: bool = False

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.m), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Scalar-order CSR SpMV golden model (reference main.cu:101-110)."""
        rows = np.repeat(np.arange(self.m), np.diff(self.indptr))
        prod = self.data * x[self.indices]
        y = np.zeros(self.m, dtype=np.result_type(self.data, x))
        np.add.at(y, rows, prod)
        return y


def csr_from_coo(m: int, n: int, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, sum_duplicates: bool = True,
                 is_symmetric: bool = False) -> CSRMatrix:
    """Build canonical CSR (rows-major, columns sorted, duplicates summed)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key_same = np.zeros(rows.size, dtype=bool)
        key_same[1:] = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            group = np.cumsum(~key_same) - 1
            n_groups = group[-1] + 1
            new_vals = np.zeros(n_groups, dtype=vals.dtype)
            np.add.at(new_vals, group, vals)
            first = ~key_same
            rows, cols, vals = rows[first], cols[first], new_vals
    counts = np.bincount(rows, minlength=m).astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix((m, n), indptr, cols.astype(np.int32), vals,
                     is_symmetric=is_symmetric)


def _open_text(path_or_file) -> _io.TextIOBase:
    if hasattr(path_or_file, "read"):
        return path_or_file
    p = str(path_or_file)
    if p.endswith(".gz"):
        return _io.TextIOWrapper(gzip.open(p, "rb"))
    return open(p, "r")


def read_banner(line: str) -> tuple[str, str, str, str]:
    """Parse the %%MatrixMarket banner (reference mmio.h:398-466)."""
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixMarketError(f"bad Matrix Market banner: {line!r}")
    obj, fmt, field, sym = (s.lower() for s in parts[1:])
    if obj not in _VALID_OBJECTS:
        raise MatrixMarketError(f"unsupported object {obj!r}")
    if fmt not in _VALID_FORMATS:
        raise MatrixMarketError(f"unsupported format {fmt!r}")
    if field not in _VALID_FIELDS:
        raise MatrixMarketError(f"unsupported field {field!r}")
    if sym not in _VALID_SYMMETRIES:
        raise MatrixMarketError(f"unsupported symmetry {sym!r}")
    if fmt == "array" and field == "pattern":
        raise MatrixMarketError("array format cannot be pattern")
    return obj, fmt, field, sym


def _expand_symmetry(sym: str, rows, cols, vals):
    """Mirror off-diagonal entries for symmetric/hermitian files
    (mmio_highlevel.h:687-731); skew-symmetric negates the mirror."""
    if sym not in ("symmetric", "hermitian", "skew-symmetric") \
            or rows.size == 0:
        return rows, cols, vals
    off = rows != cols
    mrows, mcols = cols[off], rows[off]
    mvals = -vals[off] if sym == "skew-symmetric" else vals[off]
    return (np.concatenate([rows, mrows]),
            np.concatenate([cols, mcols]),
            np.concatenate([vals, mvals]))


def load_mtx(path_or_file: Union[str, "_io.TextIOBase"],
             value_dtype=np.float64) -> CSRMatrix:
    """Load a Matrix Market file into canonical CSR.

    Equivalent of reference `mmio_allinone` (mmio_highlevel.h:593).
    """
    f = _open_text(path_or_file)
    banner = f.readline()
    _, fmt, field, sym = read_banner(banner)

    # Skip comments, read the size line (reference mmio.h:568-607).
    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    if not line:
        raise MatrixMarketError("missing size line")
    size_parts = line.split()

    body = f.read()

    if fmt == "array":
        if len(size_parts) != 2:
            raise MatrixMarketError("array size line must be 'm n'")
        m, n = int(size_parts[0]), int(size_parts[1])
        vals = np.array(body.split()).astype(np.float64)
        if field == "complex":
            vals = vals[0::2]  # real part
        if sym == "general":
            if vals.size != m * n:
                raise MatrixMarketError("array entry count mismatch")
            dense = vals.reshape(n, m).T  # column-major file order
        else:
            # lower-triangular column-major packed
            expect = m * (m + 1) // 2 if sym in ("symmetric", "hermitian") \
                else m * (m - 1) // 2
            if vals.size != expect:
                raise MatrixMarketError("array entry count mismatch")
            dense = np.zeros((m, n))
            ri, ci = np.tril_indices(m, k=0 if sym in ("symmetric", "hermitian") else -1)
            order = np.lexsort((ri, ci))  # column-major within lower triangle
            dense[ri[order], ci[order]] = vals
            mirror = dense.T.copy()
            np.fill_diagonal(mirror, 0.0)
            dense = dense + (-mirror if sym == "skew-symmetric" else mirror)
        rows, cols = np.nonzero(dense)
        return csr_from_coo(m, n, rows.astype(np.int64), cols.astype(np.int64),
                            dense[rows, cols].astype(value_dtype),
                            is_symmetric=sym != "general")

    if len(size_parts) != 3:
        raise MatrixMarketError("coordinate size line must be 'm n nnz'")
    m, n, nnz = int(size_parts[0]), int(size_parts[1]), int(size_parts[2])

    # native body parser (native/mmio_parse.cpp); the NumPy tokenizer
    # runs only as the fallback (tokenizing first would cost the dominant
    # parse time even when the native path succeeds)
    from ..core import native as _native
    parsed = _native.parse_coord_body(body.encode(), nnz, field)
    if parsed is not None:
        rows, cols, vals = parsed
        vals = np.ones(nnz, value_dtype) if field == "pattern" \
            else vals.astype(value_dtype)
    else:
        tokens = np.array(body.split())
        per_entry = {"pattern": 2, "real": 3, "integer": 3,
                     "complex": 4}[field]
        if tokens.size < nnz * per_entry:
            raise MatrixMarketError(
                f"expected {nnz} entries x {per_entry} tokens, "
                f"got {tokens.size}")
        tokens = tokens[: nnz * per_entry].reshape(nnz, per_entry)
        rows = tokens[:, 0].astype(np.int64) - 1
        cols = tokens[:, 1].astype(np.int64) - 1
        if field == "pattern":
            vals = np.ones(nnz, dtype=value_dtype)
        else:
            vals = tokens[:, 2].astype(np.float64).astype(value_dtype)

    if nnz and (rows.min() < 0 or cols.min() < 0 or rows.max() >= m
                or cols.max() >= n):
        raise MatrixMarketError("entry index out of bounds")
    rows, cols, vals = _expand_symmetry(sym, rows, cols, vals)
    return csr_from_coo(m, n, rows, cols, vals,
                        is_symmetric=sym != "general")


def save_mtx(path: str, csr: CSRMatrix, field: str = "real",
             symmetry: str = "general") -> None:
    """Write a coordinate .mtx — the full writer set of the reference
    (mmio.h:26-28,142 banner/size writers + the crd writers at
    :686-830): field real / integer / pattern / complex, symmetry
    general / symmetric. Bulk-formatted (np.savetxt) — a per-entry
    Python loop is unusable for writing large matrices.

    * `pattern` drops the value column (the loader reads 1.0 back).
    * `integer` writes values as integers (they must be integral).
    * `complex` writes `re im` value pairs (mmio.h:780-830). CSRMatrix
      carries real values only (the loader keeps the real part of
      complex files, mmio_highlevel.h:648-676), so the imaginary
      column is written as 0 and values round-trip exactly.
    * `symmetric` writes only the lower triangle (entry (i, j) with
      j <= i); the matrix must actually be symmetric — the loader's
      expansion reconstructs the mirror on read.
    """
    if field not in ("real", "integer", "pattern", "complex"):
        raise MatrixMarketError(f"cannot write field {field!r}")
    if symmetry not in ("general", "symmetric"):
        raise MatrixMarketError(f"cannot write symmetry {symmetry!r}")
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    cols = np.asarray(csr.indices, np.int64)
    vals = np.asarray(csr.data, np.float64)
    if symmetry == "symmetric":
        if csr.m != csr.n:
            raise MatrixMarketError("symmetric writer needs a square "
                                    "matrix")
        keep = cols <= rows
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{csr.m} {csr.n} {rows.size}\n")
        if field == "pattern":
            out = np.column_stack([rows + 1, cols + 1])
            np.savetxt(f, out, fmt="%d %d")
        elif field == "integer":
            iv = vals.astype(np.int64)
            if not np.array_equal(iv.astype(np.float64), vals):
                raise MatrixMarketError(
                    "integer writer given non-integral values")
            out = np.column_stack([rows + 1, cols + 1, iv])
            np.savetxt(f, out, fmt="%d %d %d")
        elif field == "complex":
            out = np.column_stack([
                (rows + 1).astype(np.float64),
                (cols + 1).astype(np.float64), vals,
                np.zeros(vals.size)])
            np.savetxt(f, out, fmt="%d %d %.17g %.17g")
        else:
            out = np.column_stack([
                (rows + 1).astype(np.float64),
                (cols + 1).astype(np.float64), vals])
            np.savetxt(f, out, fmt="%d %d %.17g")
