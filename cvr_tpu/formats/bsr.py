"""BSR-128: dense-brick format for SpMM on locality-structured matrices.

SpMV is gather-bound — but SpMM with a wide dense RHS changes the
economics.  For every occupied 128x128 column brick of A, the
contribution ``Y[rb] += A_brick @ X[cb]`` is a dense [128,128] x [128,K]
matmul, and the whole SpMM is one batched matmul that XLA hands to
cuBLAS.  On a locality-structured matrix (the reference's road / routing
/ FEM / engineering domains, CVR paper Table 2) the brick fill ratio is
5-15%, so the matrix unit's rate can outrun the 1/fill FLOP blowup of
densification (the reference has no SpMM at all; its closest analogue
is the dense-block 2D cache blocking of VHCC, vhcc_matrix.h:300-375,
which also trades padding for streaming regularity).

Precision: the matmul runs at ``Precision.HIGHEST`` — full f32 on the
GPU, never TF32 — giving ~2e-7 relative error vs a float64 golden, the
same verification contract as the SpMV paths (spmv.cpp:1916-1938
analogue in cvr_tpu/ops/spmv_ref.py).

``bsr_pack`` raises :class:`BsrInfeasible` when densification would
explode memory (power-law matrices — fill below ``min_fill``; or a device
layout past ``max_bytes``, which pads every 128-row block to the widest,
so bricks spread unevenly over row blocks cost far more than their
count); callers fall back to the SELL SpMM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.utils.timing import PhaseTimer

B = 128  # brick edge
MAX_BYTES = 6 << 30  # default cap on the dense bricks a pack may allocate


class BsrInfeasible(ValueError):
    """Brick fill too low — densification would waste memory/FLOPs."""


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ell_width(brick_row: np.ndarray, nrb: int) -> int:
    """Brick slots per row block in the device layout: the widest row
    block's brick count (at least 1; ops/spmm_bsr.py pads to it)."""
    if brick_row.size == 0:
        return 1
    return max(1, int(np.bincount(brick_row, minlength=nrb).max()))


def check_bytes(nbricks: int, max_bytes: int, what: str) -> None:
    """Raise BsrInfeasible when ``nbricks`` dense f32 bricks exceed
    ``max_bytes``."""
    if nbricks * B * B * 4 > max_bytes:
        raise BsrInfeasible(
            f"{nbricks} bricks {what} = {nbricks * B * B * 4 / 1e9:.1f} GB "
            f"dense (max {max_bytes / 1e9:.1f} GB)"
        )


@dataclass
class BsrMatrix:
    """Host-side BSR-128 artifact (dense f32 bricks, sorted by row block)."""

    vals: np.ndarray  # (nbricks, B, B) f32 dense bricks
    brick_row: np.ndarray  # (nbricks,) int32, non-decreasing
    brick_col: np.ndarray  # (nbricks,) int32
    shape: tuple[int, int]
    nnz: int
    convert_time: float = 0.0
    convert_phases: dict = field(default_factory=dict)

    @property
    def nbricks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def fill(self) -> float:
        return self.nnz / max(1, self.nbricks * B * B)

    @property
    def padded_nnz(self) -> int:
        return self.nbricks * B * B

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path,
            vals=self.vals, brick_row=self.brick_row,
            brick_col=self.brick_col,
            shape=np.asarray(self.shape, dtype=np.int64),
            nnz=np.int64(self.nnz),
        )

    @staticmethod
    def load(path: str | Path) -> "BsrMatrix":
        z = np.load(path)
        return BsrMatrix(
            vals=z["vals"], brick_row=z["brick_row"],
            brick_col=z["brick_col"],
            shape=tuple(int(v) for v in z["shape"]),
            nnz=int(z["nnz"]),
        )


def bsr_pack(
    csr: CSRMatrix,
    min_fill: float = 0.005,
    max_bytes: int = MAX_BYTES,
) -> BsrMatrix:
    """CSR -> BSR-128 densification (O(nnz log nnz); a reported metric).

    min_fill / max_bytes gate the densification cost: a power-law matrix
    scatters nnz across bricks so thinly that dense bricks are pure
    waste — those raise BsrInfeasible (use the SELL SpMM).  max_bytes
    bounds both the occupied bricks and the device layout (every row
    block padded to the widest).
    """
    from cvr_tpu import _native

    pt = PhaseTimer()
    nrows, ncols = csr.shape
    nnz = csr.nnz
    ncb = max(1, _round_up(ncols, B) // B)
    native_ok = _native.available()

    with pt.phase("bricks"):
        if native_ok:
            nb = _native.bsr_count_native(nrows, ncb, csr.rowptr, csr.cols)
        else:
            lengths = np.diff(csr.rowptr)
            r = np.repeat(np.arange(nrows, dtype=np.int64), lengths)
            c = csr.cols.astype(np.int64)
            key = (r >> 7) * ncb + (c >> 7)
            bricks, inv = np.unique(key, return_inverse=True)
            nb = int(bricks.shape[0])
        check_bytes(nb, max_bytes, "occupied")
        fill = nnz / max(1, nb * B * B)
        if fill < min_fill:
            raise BsrInfeasible(
                f"brick fill {fill:.4f} < {min_fill} — no block locality; "
                "use the SELL SpMM"
            )

    with pt.phase("fill"):
        if native_ok:
            brick_row, brick_col, vals = _native.bsr_fill_native(
                nrows, ncb, csr.rowptr, csr.cols,
                csr.vals.astype(np.float32), nb,
            )
        else:
            brick_row = (bricks // ncb).astype(np.int32)
            brick_col = (bricks % ncb).astype(np.int32)
            vals = np.zeros((nb, B, B), dtype=np.float32)
            dest = (inv << 14) + ((r & 127) << 7) + (c & 127)
            # CSR has unique (row, col) pairs so plain scatter is exact.
            vals.reshape(-1)[dest] = csr.vals.astype(np.float32)
        nrb = max(1, _round_up(nrows, B) // B)
        check_bytes(
            nrb * ell_width(brick_row, nrb), max_bytes,
            "on the device (row blocks padded to the widest)",
        )

    return BsrMatrix(
        vals=vals,
        brick_row=brick_row,
        brick_col=brick_col,
        shape=csr.shape,
        nnz=nnz,
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )
