"""COO (coordinate) sparse matrix container.

Host-side (NumPy) container; the reference's equivalent is the Coordinate
triple array read by readMatrix (spmv.cpp:62-66,311-535).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _row_major_order(rows, cols, ncols: int) -> np.ndarray:
    """(row, col) sort order: one argsort of an int64 key, several times
    faster than a two-key lexsort at tens of millions of entries.  The
    order among duplicate (row, col) entries is unspecified."""
    key = rows.astype(np.int64) * max(int(ncols), 1) + cols
    return np.argsort(key)


@dataclass
class COOMatrix:
    rows: np.ndarray  # [nnz] int
    cols: np.ndarray  # [nnz] int
    vals: np.ndarray  # [nnz] float
    shape: tuple[int, int]

    def __post_init__(self):
        self.rows = np.asarray(self.rows)
        self.cols = np.asarray(self.cols)
        self.vals = np.asarray(self.vals)
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")
        if self.rows.ndim != 1:
            raise ValueError("COO arrays must be 1-D")

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def transpose(self) -> "COOMatrix":
        """A^T (swap row/col ids) — e.g. PageRank follows in-links."""
        return COOMatrix(
            rows=self.cols,
            cols=self.rows,
            vals=self.vals,
            shape=(self.shape[1], self.shape[0]),
        )

    def sorted_by_row(self) -> "COOMatrix":
        """(row, col) sort — the reference qsorts COO the same way before
        CSR assembly (spmv.cpp:485, comparator spmv.cpp:131-144)."""
        order = _row_major_order(self.rows, self.cols, self.shape[1])
        return COOMatrix(
            rows=self.rows[order],
            cols=self.cols[order],
            vals=self.vals[order],
            shape=self.shape,
        )

    def sum_duplicates(self) -> "COOMatrix":
        """Coalesce duplicate (row, col) entries by summation."""
        order = _row_major_order(self.rows, self.cols, self.shape[1])
        r, c, v = self.rows[order], self.cols[order], self.vals[order]
        if r.size == 0:
            return COOMatrix(r, c, v, self.shape)
        new_group = np.empty(r.size, dtype=bool)
        new_group[0] = True
        new_group[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        idx = np.flatnonzero(new_group)
        sums = np.add.reduceat(v.astype(np.float64), idx).astype(v.dtype)
        return COOMatrix(r[idx], c[idx], sums, self.shape)

    def to_csr(self, sort_cols: bool = True) -> "CSRMatrix":
        """Assemble CSR.  sort_cols=True yields canonical (col-sorted rows,
        scipy-comparable) form via lexsort; sort_cols=False keeps insertion
        order within rows and uses the native O(nnz) counting sort when
        available (column order within a row is irrelevant for SpMV)."""
        from cvr_tpu.formats.csr import CSRMatrix

        nrows = self.shape[0]
        if not sort_cols and self.vals.dtype == np.float32:
            try:
                from cvr_tpu import _native

                if _native.available():
                    rowptr, cols, vals = _native.coo_to_csr_native(
                        nrows, self.rows, self.cols, self.vals
                    )
                    return CSRMatrix(
                        rowptr=rowptr, cols=cols, vals=vals, shape=self.shape
                    )
            except Exception:
                pass
        if sort_cols:
            order = _row_major_order(self.rows, self.cols, self.shape[1])
        else:
            order = np.argsort(self.rows, kind="stable")
        counts = np.bincount(
            self.rows, minlength=nrows
        ).astype(np.int64)
        rowptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=rowptr[1:])
        return CSRMatrix(
            rowptr=rowptr,
            cols=self.cols[order].astype(np.int32),
            vals=self.vals[order],
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        dense = np.zeros(self.shape, dtype=np.float64)
        np.add.at(dense, (self.rows, self.cols), self.vals.astype(np.float64))
        return dense.astype(self.vals.dtype)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.vals, (self.rows, self.cols)), shape=self.shape
        )

    @staticmethod
    def from_scipy(m) -> "COOMatrix":
        m = m.tocoo()
        return COOMatrix(
            rows=m.row.astype(np.int32),
            cols=m.col.astype(np.int32),
            vals=m.data,
            shape=m.shape,
        )
