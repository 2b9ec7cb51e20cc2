"""BELL: banded-ELL planes in natural row order + SELL spill.

The format for the road domain (reference paper Table 2/3: road_usa,
~2.5 nnz/row, nnz concentrated near the diagonal; CVR wins it 1.37x
over its second best, spmv.cpp:1197-1233 is the loop to beat).  Unlike
SELL there is NO row sort: rows keep their natural order (which IS the
x locality), the k densest per-row entries fill k (offset, value)
planes consumed by one gather-MAC (ops/spmv_bell.py), and the leftovers
— rows deeper than k or entries farther than the reach cap — spill to a
small SELL residual.  Pack cost is a few vectorized numpy passes: the
conversion time CVR treats as a first-class metric all but vanishes
where the matrix is banded-sparse.

Plane layout: rows are grouped in tiles of 1024 (8 sublanes of 128);
``li`` holds the column relative to the tile's window base,
``col - 1024 * (row >> 10) + 128 * cr`` with ``cr = ceil(reach / 128)``,
so an int16 covers the whole window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.formats.sell import SellMatrix, sell_pack

# li is int16 in [0, 2048): the window spans 16 sublanes of 128 columns.
REACH_CAP = 448


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class BellInfeasible(ValueError):
    """Matrix not banded-sparse enough for BELL (see bell_pack gate)."""


@dataclasses.dataclass
class BellMatrix:
    """Host-side BELL artifact (see to_device_bell)."""

    li: np.ndarray  # (k, R_sub, 128) int16 window offsets
    vals: np.ndarray  # (k, R_sub, 128) f32
    spill: SellMatrix | None  # residual entries (row-compressed)
    spill_map: np.ndarray | None  # natural rows of the compressed spill
    shape: tuple
    nnz: int
    reach: int
    k: int
    d: int  # window phase: tile t's base sublane is 8t + d in xt coords
    pre: int  # zero sublanes prepended to x
    convert_time: float = 0.0
    convert_phases: dict | None = None

    @property
    def R_sub(self) -> int:
        return self.li.shape[1]

    @property
    def padded_nnz(self) -> int:
        """Stored plane slots plus the spill's padded slots."""
        spill = self.spill.padded_nnz if self.spill is not None else 0
        return self.k * self.R_sub * 128 + spill


def bell_pack(
    csr: CSRMatrix,
    k: int | None = None,
    max_spill: float = 0.02,
    max_k: int = 12,
) -> BellMatrix:
    """Pack a banded-sparse CSR into BELL planes + SELL spill.

    Gate: at least (1 - max_spill) of the nnz must sit within
    REACH_CAP columns of the diagonal AND within the first k entries
    of their row, for some k <= max_k; otherwise BellInfeasible.
    """
    from cvr_tpu import _native

    t0 = time.perf_counter()
    nrows, ncols = csr.shape
    nnz = int(csr.vals.size)
    if nnz == 0:
        raise BellInfeasible("empty matrix")
    use_native = _native.available() and hasattr(
        _native, "bell_fill_native"
    )
    if use_native:
        near_lens, reach = _native.bell_stats_native(
            csr.rowptr, csr.cols, REACH_CAP
        )
        near_lens = near_lens.astype(np.int64)
    else:
        lens = np.diff(csr.rowptr)
        rows = np.repeat(np.arange(nrows, dtype=np.int64), lens)
        aoff = np.abs(csr.cols.astype(np.int64) - rows)
        near = aoff <= REACH_CAP
        reach = int(aoff[near].max()) if near.any() else 0
        cum0 = np.concatenate(([0], np.cumsum(near.astype(np.int64))))
        near_lens = cum0[csr.rowptr[1:]] - cum0[csr.rowptr[:-1]]
    if k is None:
        k = 1
        while k <= max_k:
            kept = int(np.minimum(near_lens, k).sum())
            if nnz - kept <= max_spill * nnz:
                break
            k += 1
    spilled = nnz - int(np.minimum(near_lens, k).sum())
    if k > max_k or spilled > max_spill * nnz:
        raise BellInfeasible(
            f"spill {spilled / nnz:.1%} at k={min(k, max_k)} over the "
            f"{max_spill:.0%} gate"
        )
    cr = -(-reach // 128)
    R_sub = _round_up(max(-(-max(nrows, 1) // 128), 1), 8)

    if use_native:
        li, vals, sp_rows, sp_cols, sp_vals = _native.bell_fill_native(
            csr.rowptr, csr.cols, csr.vals, k, REACH_CAP, cr,
            R_sub * 128, spilled,
        )
    else:
        cum = np.cumsum(near.astype(np.int64))
        row_base = np.concatenate(([0], cum))[csr.rowptr[:-1]]
        rank = cum - 1 - np.repeat(row_base, lens)
        in_plane = near & (rank < k)
        li = np.zeros((k, R_sub * 128), dtype=np.int16)
        vals = np.zeros((k, R_sub * 128), dtype=np.float32)
        r_in = rows[in_plane]
        li_v = (
            csr.cols.astype(np.int64)[in_plane]
            - ((r_in >> 10) << 10)
            + 128 * cr
        )
        li[rank[in_plane], r_in] = li_v.astype(np.int16)
        vals[rank[in_plane], r_in] = csr.vals[in_plane]
        sp = ~in_plane
        sp_rows = rows[sp].astype(np.int32)
        sp_cols = csr.cols[sp]
        sp_vals = csr.vals[sp]
    pre = _round_up(cr, 8)
    d = pre - cr
    li = li.reshape(k, R_sub, 128)
    vals = vals.reshape(k, R_sub, 128)

    spill = None
    spill_map = None
    if sp_rows.size:
        # compress the spill to its occupied rows: the residual's pack
        # and SpMV scale with the spill, not with nrows (spmv adds the
        # compressed y back through spill_map)
        spill_map, sp_rows_c = np.unique(sp_rows, return_inverse=True)
        sp_rowptr = np.zeros(spill_map.size + 1, dtype=np.int64)
        np.cumsum(
            np.bincount(sp_rows_c, minlength=spill_map.size),
            out=sp_rowptr[1:],
        )
        # spill entries are row-then-col sorted already (CSR order)
        sp_csr = CSRMatrix(
            rowptr=sp_rowptr,
            cols=sp_cols,
            vals=sp_vals,
            shape=(int(spill_map.size), ncols),
        )
        spill = sell_pack(sp_csr)
    dt = time.perf_counter() - t0
    phases = {"bell": dt}
    if spill is not None:
        phases.update(
            {f"spill_{p}": v for p, v in (spill.convert_phases or {}).items()}
        )
    return BellMatrix(
        li=li,
        vals=vals,
        spill=spill,
        spill_map=spill_map,
        shape=(nrows, ncols),
        nnz=nnz,
        reach=reach,
        k=k,
        d=d,
        pre=pre,
        convert_time=dt,
        convert_phases=phases,
    )


def save_bell(bm: BellMatrix, path) -> None:
    """Persist the BELL artifact (the SELL spill embedded as bytes; same
    amortization workflow as SellMatrix.save)."""
    import io

    spill_buf = b""
    if bm.spill is not None:
        bio = io.BytesIO()
        bm.spill.save(bio)
        spill_buf = bio.getvalue()
    np.savez_compressed(
        path,
        bell_li=bm.li,
        bell_vals=bm.vals,
        bell_meta=np.asarray(
            [bm.shape[0], bm.shape[1], bm.nnz, bm.reach, bm.k, bm.d, bm.pre],
            dtype=np.int64,
        ),
        bell_spill=np.frombuffer(spill_buf, dtype=np.uint8),
        bell_spill_map=(
            bm.spill_map
            if bm.spill_map is not None
            else np.zeros(0, dtype=np.int64)
        ),
    )


def load_bell(path) -> BellMatrix:
    import io

    z = np.load(path)
    m = z["bell_meta"]
    spill = None
    raw = z["bell_spill"]
    if raw.size:
        spill = SellMatrix.load(io.BytesIO(raw.tobytes()))
    smap = z["bell_spill_map"]
    return BellMatrix(
        li=z["bell_li"],
        vals=z["bell_vals"],
        spill=spill,
        spill_map=smap if smap.size else None,
        shape=(int(m[0]), int(m[1])),
        nnz=int(m[2]),
        reach=int(m[3]),
        k=int(m[4]),
        d=int(m[5]),
        pre=int(m[6]),
    )
