"""Comm-volume accounting and weak-scaling projection for dist SpMV.

BASELINE.md sets a >=70% weak-scaling efficiency target for the
row-sharded SpMV (parallel/dist.py).  This module is the hardware-free
half of that requirement: an explicit per-iteration byte account (what
each shard streams from HBM vs what it receives from the other cards)
and a projection of weak-scaling efficiency for the blocking all-gather
path and for an ideally overlapped one.

Model (1D row sharding, x_sharded=True, weak scaling = every device
holds one copy of the benchmark matrix, so the global problem is D x
larger and the gathered x is D x longer):

  t_comp          constant per device (the measured one-card SpMV).
  gather bytes    (D-1) * ncols * 4 received per device per iteration
                  (all-gather of the D*ncols global x).
  t_comm(D)       gather_bytes / NVLINK_BW: the cards of one host are
                  joined all to all, so each receives from the others
                  at its full per-direction NVLink rate.
  blocking        T(D) = t_comp + t_comm(D)
  overlapped      T(D) = max(t_comp, t_comm(D)) — the bound a gather
                  hidden behind compute could reach.
  E(D)            t_comp / T(D); target >= 0.70 (BASELINE.md).

With 1D row sharding the received bytes grow linearly in D while
per-device compute stays flat, so E(D) has a hard knee at
t_comm(D) ~ t_comp.  Past it the fix is a 2D (row x col) mesh that
gathers only a column block of x per device.
"""

from __future__ import annotations

from dataclasses import dataclass

# Per-card NVLink bandwidth in one direction, bytes/s.  H100 SXM: 900
# GB/s total NVLink bandwidth, 450 GB/s each way, all to all among the
# cards of one host (NVIDIA H100 data sheet).
NVLINK_BW = 450e9


@dataclass
class CommRow:
    name: str
    D: int
    stream_bytes: int  # HBM bytes per device per iteration
    gather_bytes: int  # bytes received per device per iteration
    t_comp_s: float
    t_comm_s: float
    eff_blocking: float
    eff_overlap: float


def sell_stream_bytes(padded_nnz: int) -> int:
    """HBM bytes one device streams per SELL SpMV iteration: a 4-byte
    value and a 4-byte column id per stored slot (x and y traffic,
    O(nrows), is left out)."""
    return padded_nnz * 8


def weak_scaling(
    t_comp_s: float, ncols: int, D: int, bw: float = NVLINK_BW
) -> tuple[float, float, float]:
    """(t_comm, E_blocking, E_overlap) for D devices, weak scaling."""
    t_comm = (D - 1) * ncols * 4 / bw
    e_block = t_comp_s / (t_comp_s + t_comm)
    e_ov = t_comp_s / max(t_comp_s, t_comm)
    return t_comm, e_block, e_ov


def knee_devices(
    t_comp_s: float, ncols: int, target: float = 0.70, bw: float = NVLINK_BW
) -> tuple[int, int]:
    """Largest D keeping E >= target, (blocking, overlap) paths."""

    def largest(eff_idx: int) -> int:
        d, last = 2, 1
        while d <= 1 << 20:
            if weak_scaling(t_comp_s, ncols, d, bw)[eff_idx] < target:
                break
            last = d
            d *= 2
        lo, hi = last, min(d, 1 << 20)
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if weak_scaling(t_comp_s, ncols, mid, bw)[eff_idx] >= target:
                lo = mid
            else:
                hi = mid
        return lo

    return largest(1), largest(2)


def comm_table(rows, D: int = 4) -> list[CommRow]:
    """Build CommRows from bench-result dicts (BenchResult JSON lines).

    Each row needs: name, ncols, padded_nnz, spmv_s.  Rows without ncols
    are skipped.
    """
    out = []
    for r in rows:
        ncols = int(r.get("ncols") or 0)
        if not ncols:
            continue
        t_comp = float(r["spmv_s"])
        t_comm, e_b, e_o = weak_scaling(t_comp, ncols, D)
        out.append(
            CommRow(
                name=r["name"],
                D=D,
                stream_bytes=sell_stream_bytes(int(r["padded_nnz"])),
                gather_bytes=(D - 1) * ncols * 4,
                t_comp_s=t_comp,
                t_comm_s=t_comm,
                eff_blocking=e_b,
                eff_overlap=e_o,
            )
        )
    return out
