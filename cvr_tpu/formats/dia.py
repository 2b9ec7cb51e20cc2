"""DIA: the diagonal format — banded matrices as pure streaming.

A strictly banded matrix (the reference's banded/stencil EngSci inputs;
CVR paper Table 2 lists several) is not a gather problem at all: with
nonzeros on nd dense diagonals,

    y[r] = sum_k  band_k[r] * x[r + off_k]

is nd shifted elementwise FMAs over contiguous x slices — no indices and
no gathers.  XLA fuses the shifts and FMAs into one streaming loop, so
SpMV runs at HBM rate (~4 B of band + ~amortized x per nnz).  This is the
fast path the same way AVX-512 lockstep streaming is the reference's best
case (CVR's trackers advance uniformly on regular rows,
spmv.cpp:1351-1437; scipy ships the same format as sparse.dia_matrix).

``dia_pack`` gates hard: every nonzero must lie on one of at most
``max_diags`` diagonals whose mean fill is at least ``min_fill`` —
otherwise DiaInfeasible, and callers fall back to BELL / SELL
(cvr_tpu.formats.pack_auto).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.utils.timing import PhaseTimer


class DiaInfeasible(ValueError):
    """Nonzeros not concentrated on few dense diagonals — use SELL-W/R."""


@dataclass
class DiaMatrix:
    """Host-side DIA artifact.

    ``bands[k, r] = A[r, r + offsets[k]]`` (row-aligned storage; zero
    where the diagonal leaves the matrix).
    """

    offsets: np.ndarray  # (nd,) int64, sorted
    bands: np.ndarray  # (nd, nrows) f32
    shape: tuple[int, int]
    nnz: int
    convert_time: float = 0.0
    convert_phases: dict = field(default_factory=dict)

    @property
    def nd(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def padded_nnz(self) -> int:
        return self.nd * self.shape[0]

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path,
            offsets=self.offsets, bands=self.bands,
            shape=np.asarray(self.shape, dtype=np.int64),
            nnz=np.int64(self.nnz),
        )

    @staticmethod
    def load(path: str | Path) -> "DiaMatrix":
        z = np.load(path)
        return DiaMatrix(
            offsets=z["offsets"], bands=z["bands"],
            shape=tuple(int(v) for v in z["shape"]), nnz=int(z["nnz"]),
        )


def dia_pack(
    csr: CSRMatrix, max_diags: int = 64, min_fill: float = 0.25
) -> DiaMatrix:
    """CSR -> DIA (O(nnz) streaming; a reported metric).

    Gate: at most ``max_diags`` distinct diagonals and aggregate fill
    (nnz over nd * nrows) at least ``min_fill`` — a scattered matrix
    smeared over many sparse diagonals would waste memory and FLOPs.
    """
    from cvr_tpu import _native

    pt = PhaseTimer()
    nrows, ncols = csr.shape
    nnz = csr.nnz
    native_ok = _native.available() and hasattr(_native, "dia_fill_native")
    with pt.phase("offsets"):
        if native_ok:
            offsets = _native.dia_offsets_native(
                csr.rowptr, csr.cols, nrows, ncols
            )
        else:
            lengths = np.diff(csr.rowptr)
            rows = np.repeat(
                np.arange(nrows, dtype=np.int64), lengths
            )
            offs_all = csr.cols.astype(np.int64) - rows
            offsets = np.unique(offs_all)
        if offsets.shape[0] > max_diags:
            raise DiaInfeasible(
                f"{offsets.shape[0]} distinct diagonals > {max_diags}"
            )
        fill = nnz / max(1, offsets.shape[0] * nrows)
        if fill < min_fill:
            raise DiaInfeasible(
                f"diagonal fill {fill:.3f} < {min_fill}"
            )
    with pt.phase("bands"):
        if native_ok:
            bands = _native.dia_fill_native(
                csr.rowptr, csr.cols, csr.vals, offsets, nrows
            )
        else:
            bands = np.zeros((offsets.shape[0], nrows), dtype=np.float32)
            k = np.searchsorted(offsets, offs_all)
            bands[k, rows] = csr.vals.astype(np.float32)
    return DiaMatrix(
        offsets=offsets,
        bands=bands,
        shape=csr.shape,
        nnz=nnz,
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )
