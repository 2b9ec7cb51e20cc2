from cvr_tpu.formats.bell import BellInfeasible, BellMatrix, bell_pack
from cvr_tpu.formats.bsr import BsrInfeasible, BsrMatrix, bsr_pack
from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.formats.dia import DiaInfeasible, DiaMatrix, dia_pack
from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.formats.sell import SellMatrix, sell_pack, sell_unpack

__all__ = [
    "BellInfeasible",
    "BellMatrix",
    "bell_pack",
    "BsrInfeasible",
    "BsrMatrix",
    "bsr_pack",
    "DiaInfeasible",
    "DiaMatrix",
    "dia_pack",
    "COOMatrix",
    "CSRMatrix",
    "SellMatrix",
    "sell_pack",
    "sell_unpack",
    "pack_auto",
]


def pack_auto(csr: CSRMatrix):
    """Pick the packed format for this matrix: DIA -> BELL -> SELL.

    Each structure gate either accepts the matrix or raises its
    ``*Infeasible``; SELL takes any structure.  This mirrors the
    reference's positioning of CVR as the one format that handles both
    regular and scale-free matrices (paper Table 3) — here the dispatch
    is explicit and the artifact's type records which path it took.
    """
    # Strictly banded/stencil matrices: the DIA path is pure streaming
    # (no gathers at all).
    try:
        return dia_pack(csr)
    except DiaInfeasible:
        pass
    # Banded-SPARSE matrices (road class: few nnz/row, all near the
    # diagonal, no dense diagonals): BELL keeps natural row order and
    # packs in a few vectorized passes.
    try:
        return bell_pack(csr)
    except BellInfeasible:
        pass
    return sell_pack(csr)
