"""Distributed DIA SpMV/SpMM: row-sharded diagonal bands over a Mesh.

The band planes split by row range (equal rows — DIA work is uniform per
row, so no nnz balancing is needed); each shard runs the shifted-FMA
kernel (cvr_tpu/ops/spmv_dia.py) on its slice, reading the x entries
[lo + off_min, hi + off_max) it needs from the gathered x.  Cuts are at
row boundaries, so y needs no cross-device reduction — the same
no-atomics-by-construction design as every other dist path (reference
analogue: disjoint OpenMP shards, spmv.cpp:577-627).
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
from cvr_tpu.formats.dia import DiaMatrix, dia_pack
from cvr_tpu.parallel.dist import AXIS, make_mesh  # noqa: F401


@dataclass
class DistDiaMatrix:
    """Row-sharded band planes stacked on a leading device axis."""

    bands: jax.Array  # [D, nd, rows_max] f32
    offsets: tuple  # static, shared by all shards
    bounds: np.ndarray  # [D + 1] row bounds (equal split)
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    rows_max: int

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def dist_dia_pack(csr: CSRMatrix, mesh: Mesh, **pack_kw) -> DistDiaMatrix:
    """Pack once (cheap O(nnz) streaming), split the band planes by row."""
    dm: DiaMatrix = dia_pack(csr, **pack_kw)
    D = mesh.devices.size
    nrows = csr.shape[0]
    rows_max = -(-nrows // D)
    bounds = np.minimum(np.arange(D + 1) * rows_max, nrows)
    bands = np.zeros((D, dm.nd, rows_max), dtype=np.float32)
    for d in range(D):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        bands[d, :, : hi - lo] = dm.bands[:, lo:hi]
    return DistDiaMatrix(
        bands=jax.device_put(bands, NamedSharding(mesh, P(AXIS))),
        offsets=tuple(int(o) for o in dm.offsets),
        bounds=bounds,
        shape=csr.shape,
        nnz=csr.nnz,
        mesh=mesh,
        rows_max=rows_max,
    )


def dist_spmv_dia(
    dm: DistDiaMatrix, x: jax.Array, x_sharded: bool = False
) -> jax.Array:
    """y = A @ x across the mesh (x replicated, or row-sharded and
    all-gathered inside shard_map)."""
    nrows, ncols = dm.shape
    D = dm.n_shards
    lo = min(dm.offsets + (0,))
    hi = max(dm.offsets + (0,))
    base = max(-lo, 0)
    if x_sharded:
        ncp = -(-ncols // D) * D
        if x.shape[0] != ncp:
            x = jnp.pad(x, (0, ncp - x.shape[0]))
    x_spec = P(AXIS) if x_sharded else P(None)
    R = dm.rows_max

    def fn(bands, xs):
        x_full = (
            jax.lax.all_gather(xs, AXIS, tiled=True)[:ncols]
            if x_sharded
            else xs
        )
        # pad once so every shifted slice is in-bounds for every shard
        xp = jnp.pad(
            x_full.astype(jnp.float32),
            (base, max(D * R + hi - ncols, 0)),
        )
        r0 = jax.lax.axis_index(AXIS) * R
        y = jnp.zeros(R, jnp.float32)
        for k, off in enumerate(dm.offsets):
            y = y + bands[0, k] * jax.lax.dynamic_slice_in_dim(
                xp, r0 + base + off, R
            )
        return y[None]

    mapped = shard_map(
        fn,
        mesh=dm.mesh,
        in_specs=(P(AXIS), x_spec),
        out_specs=P(AXIS),
    )
    y_stacked = mapped(dm.bands, x)  # [D, rows_max]
    return y_stacked.reshape(-1)[:nrows]


def dist_spmv_dia_jit(dm: DistDiaMatrix, x_sharded: bool = False):
    return jax.jit(
        functools.partial(dist_spmv_dia, dm, x_sharded=x_sharded)
    )
