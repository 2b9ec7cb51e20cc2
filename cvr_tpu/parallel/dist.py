"""Distributed (multi-chip / multi-host) SpMV over a jax.sharding.Mesh.

The reference has no distributed layer at all (SURVEY.md §2: its only
parallelism is OpenMP fork-join over one address space, spmv.cpp:577).
This module is the multi-device extension (BASELINE.json north star): the
matrix is row-partitioned across devices with nnz balance
(partition_rows_by_nnz), each shard is SELL-packed independently, and the
dense vector x is either replicated or row-sharded and all-gathered over
the interconnect (NVLink between the cards of one host) inside shard_map
just before the per-shard SpMV.

Design notes:
  * Shards are cut at row boundaries, so y needs no cross-device
    reduction — each device owns a disjoint slice of y.  (The alternative,
    column partitioning + psum, moves y every iteration, while row
    partitioning moves x once and x is shared by all iterations of
    iterative solvers.)
  * shard_map requires identical local shapes, so every shard's planes are
    padded to the maximum shard extent before stacking on the leading
    device axis.  The packer's nnz balance keeps that padding small.
  * Multi-host: the same code runs under jax.distributed.initialize();
    the mesh then spans hosts.  See ``initialize_distributed``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.formats.sell import DEFAULT_C, SellMatrix, sell_pack
from cvr_tpu.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)

AXIS = "shards"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D device mesh over the row-shard axis (every card of a host
    reaches every other at the same NVLink rate, so no other shape)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry: thin wrapper over jax.distributed.initialize.

    Each process calls this (with coordinator_address, num_processes and
    process_id) before building the mesh; single-process runs skip it.
    """
    jax.distributed.initialize(**kwargs)


@dataclass
class DistSellMatrix:
    """Row-sharded SELL-pack matrix, stacked on a leading device axis."""

    planes: dict  # name -> jnp array with leading axis D
    bounds: np.ndarray  # [D + 1] global row bounds
    unpad_index: jax.Array  # [nrows] -> position in stacked local y
    shape: tuple[int, int]
    nnz: int
    C: int
    mesh: Mesh
    local_rows_max: int
    nslices_max: int
    balance: dict | None = None  # partition_balance diagnostics

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def _pad_to(a: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    pad = n - a.shape[axis]
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def dist_sell_pack(
    csr: CSRMatrix,
    mesh: Mesh,
    C: int = DEFAULT_C,
    sigma: int = 0,
    split_len: int | None = None,
) -> DistSellMatrix:
    """Partition rows by nnz, SELL-pack each shard, stack + device_put.

    The per-shard pack reuses the single-chip converter on the shard's
    local CSR (rows renumbered to the shard), mirroring how the reference
    converts each thread's nnz shard independently (spmv.cpp:581-1006).
    """
    D = mesh.devices.size
    bounds = partition_rows_by_nnz(csr.rowptr, D)
    shards: list[SellMatrix] = []
    for i in range(D):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        local = CSRMatrix(
            rowptr=csr.rowptr[lo : hi + 1] - csr.rowptr[lo],
            cols=csr.cols[csr.rowptr[lo] : csr.rowptr[hi]],
            vals=csr.vals[csr.rowptr[lo] : csr.rowptr[hi]],
            shape=(hi - lo, csr.shape[1]),
        )
        shards.append(sell_pack(local, C=C, sigma=sigma, split_len=split_len))

    S_max = max(s.n_slots for s in shards)
    nsl_max = max(s.nslices for s in shards)
    P_max = nsl_max * C
    rows_max = max(int(b) for b in (bounds[1:] - bounds[:-1]))

    def stack(get, n, fill=0):
        return np.stack([_pad_to(get(s), n, fill=fill) for s in shards])

    planes_np = {
        "vals_plane": stack(lambda s: s.vals_plane, S_max),
        "cols_plane": stack(lambda s: s.cols_plane, S_max),
        # Padding slots must keep their slice id monotone; give them the
        # last slice id so indices_are_sorted stays true.
        "slot_slice": np.stack(
            [
                _pad_to(s.slot_slice, S_max, fill=max(s.nslices - 1, 0))
                for s in shards
            ]
        ),
        # perm: local row per position; sentinel = local_rows (absorbed).
        "perm": np.stack(
            [
                _pad_to(
                    np.where(
                        s.perm >= s.shape[0], rows_max, s.perm
                    ).astype(np.int32),
                    P_max,
                    fill=rows_max,
                )
                for s in shards
            ]
        ),
    }
    # Per-position slice id (for padding positions past a shard's real
    # nslices the partials are zero anyway).
    # unpad: global row r lives in shard d at local index r - bounds[d];
    # stacked y is [D, rows_max] -> flat index d * rows_max + local.
    nrows = csr.shape[0]
    row_ids = np.arange(nrows, dtype=np.int64)
    shard_of_row = (
        np.searchsorted(bounds, row_ids, side="right").astype(np.int64) - 1
    )
    local_idx = row_ids - bounds[shard_of_row]
    if D * rows_max >= 2**31:
        raise ValueError(
            "stacked local-y index exceeds int32 range "
            f"({D} shards x {rows_max} padded rows)"
        )
    unpad = (shard_of_row * rows_max + local_idx).astype(np.int32)

    sharding = NamedSharding(mesh, P(AXIS))
    planes = {
        k: jax.device_put(v, sharding) for k, v in planes_np.items()
    }
    return DistSellMatrix(
        planes=planes,
        bounds=bounds,
        unpad_index=jax.device_put(
            unpad, NamedSharding(mesh, P(None))
        ),
        shape=csr.shape,
        nnz=csr.nnz,
        C=C,
        mesh=mesh,
        local_rows_max=rows_max,
        nslices_max=nsl_max,
        balance=partition_balance(csr.rowptr, bounds),
    )


def _local_spmv(vals, cols, slot_slice, perm, x_full, nslices, local_rows):
    """Per-shard SELL SpMV on local planes (shapes carry a leading 1 from
    shard_map's local view; squeezed here)."""
    vals = vals[0]
    cols = cols[0]
    slot_slice = slot_slice[0]
    perm = perm[0]
    contrib = vals * jnp.take(x_full, cols, axis=0)
    y_sorted = jax.ops.segment_sum(
        contrib, slot_slice, num_segments=nslices, indices_are_sorted=True
    )
    flat = y_sorted.reshape(-1)
    y_local = jnp.zeros(local_rows + 1, flat.dtype).at[perm].add(flat)
    return y_local[:local_rows][None]


def dist_spmv(
    dm: DistSellMatrix, x: jax.Array, x_sharded: bool = False
) -> jax.Array:
    """y = A @ x across the mesh.

    x_sharded=False: x is replicated; no communication at all.
    x_sharded=True: x enters row-sharded (P(AXIS)) and is all-gathered
    inside shard_map — the scalable pattern for matrices whose x
    does not fit per-chip or is produced sharded by an upstream op
    (BASELINE.json config #5).
    """
    mesh = dm.mesh
    nslices = dm.nslices_max
    local_rows = dm.local_rows_max
    ncols = dm.shape[1]
    D = dm.n_shards
    if x_sharded:
        # pad x to a device multiple so shard_map can split it; the
        # gathered copy is sliced back to ncols inside
        ncp = -(-ncols // D) * D
        if x.shape[0] != ncp:
            x = jnp.pad(x, (0, ncp - x.shape[0]))

    x_spec = P(AXIS) if x_sharded else P(None)

    def fn(vals, cols, slot_slice, perm, xs):
        x_full = (
            jax.lax.all_gather(xs, AXIS, tiled=True)[:ncols]
            if x_sharded
            else xs
        )
        return _local_spmv(
            vals, cols, slot_slice, perm, x_full, nslices, local_rows
        )

    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), x_spec),
        out_specs=P(AXIS),
    )
    y_stacked = mapped(
        dm.planes["vals_plane"],
        dm.planes["cols_plane"],
        dm.planes["slot_slice"],
        dm.planes["perm"],
        x,
    )  # [D, local_rows]
    return jnp.take(y_stacked.reshape(-1), dm.unpad_index, axis=0)


def dist_spmv_jit(dm: DistSellMatrix, x_sharded: bool = False):
    """A jitted closure over the matrix for iteration-heavy callers."""
    return jax.jit(
        functools.partial(dist_spmv, dm, x_sharded=x_sharded)
    )
