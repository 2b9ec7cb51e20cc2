"""Distributed BSR-128 SpMM over a jax.sharding.Mesh.

Row-block-partitioned dense-brick SpMM: each device owns a contiguous
range of 128-row blocks (balanced by brick count — the matmul work unit),
X is replicated or all-gathered inside shard_map, and each
shard runs the single-device brick SpMM (cvr_tpu/ops/spmm_bsr.py: the
row blocks' bricks as ELL slots, one batched matmul).
Cuts are at row-block boundaries so y needs no cross-device reduction
— the same no-atomics-by-construction design as the distributed SpMV
(cvr_tpu/parallel/dist.py; reference analogue: each OpenMP thread owns
a disjoint nnz shard, spmv.cpp:577-627).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from cvr_tpu.formats.bsr import (
    MAX_BYTES,
    B,
    BsrMatrix,
    bsr_pack,
    check_bytes,
    ell_width,
)
from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.ops.spmm_bsr import brick_ell
from cvr_tpu.parallel.dist import AXIS, make_mesh  # noqa: F401


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class DistBsrMatrix:
    """Brick planes stacked on a leading device axis (sharded)."""

    vals: jax.Array  # [D, nrb_local_max, maxb, B, B] f32 ELL bricks
    cols: jax.Array  # [D, nrb_local_max, maxb] int32 column blocks
    rb_bounds: np.ndarray  # [D + 1] global row-block bounds
    unpad_index: jax.Array  # [nrows] -> position in stacked local Y
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    nrb_local_max: int
    ncb: int

    @property
    def n_shards(self) -> int:
        return int(self.rb_bounds.shape[0] - 1)


def dist_bsr_pack(
    csr: CSRMatrix, mesh: Mesh, **pack_kw
) -> DistBsrMatrix:
    """Pack once, then split the brick stream at row-block boundaries so
    every shard carries ~equal brick counts (brick = matmul work unit)."""
    bm: BsrMatrix = bsr_pack(csr, **pack_kw)
    D = mesh.devices.size
    nb = bm.nbricks
    nrb = _round_up(csr.shape[0], B) // B
    ncb = _round_up(csr.shape[1], B) // B

    # Equal-brick split points, snapped down to row-block boundaries
    # (bricks are sorted by row block, so a row-block range is a slice).
    targets = (np.arange(1, D) * nb) // D
    cut_rb = bm.brick_row[np.minimum(targets, max(nb - 1, 0))] if nb else (
        np.zeros(D - 1, dtype=np.int32)
    )
    rb_bounds = np.concatenate(
        ([0], np.maximum.accumulate(cut_rb.astype(np.int64)), [nrb])
    )
    idx = np.searchsorted(bm.brick_row, rb_bounds, side="left")

    nrb_local = rb_bounds[1:] - rb_bounds[:-1]
    nrb_local_max = max(1, int(nrb_local.max()))
    maxb = ell_width(bm.brick_row, nrb)
    check_bytes(
        D * nrb_local_max * maxb, pack_kw.get("max_bytes", MAX_BYTES),
        f"stacked over {D} shards",
    )

    vals = np.zeros((D, nrb_local_max, maxb, B, B), dtype=np.float32)
    cols = np.zeros((D, nrb_local_max, maxb), dtype=np.int32)
    for d in range(D):
        lo, hi = int(idx[d]), int(idx[d + 1])
        v, c = brick_ell(
            bm.brick_row[lo:hi] - rb_bounds[d], bm.brick_col[lo:hi],
            bm.vals[lo:hi], nrb_local_max,
        )
        vals[d, :, : v.shape[1]] = v
        cols[d, :, : c.shape[1]] = c

    nrows = csr.shape[0]
    row_ids = np.arange(nrows, dtype=np.int64)
    shard_of_row = (
        np.searchsorted(
            rb_bounds * B, row_ids, side="right"
        ).astype(np.int64)
        - 1
    )
    local = row_ids - rb_bounds[shard_of_row] * B
    # the stacked flat index is device int32; guard against wraparound
    if D * nrb_local_max * B >= 2**31:
        raise ValueError(
            "stacked local-y index exceeds int32 range "
            f"({D} shards x {nrb_local_max * B} padded rows)"
        )
    unpad = (shard_of_row * (nrb_local_max * B) + local).astype(np.int32)

    sharding = NamedSharding(mesh, P(AXIS))
    return DistBsrMatrix(
        vals=jax.device_put(vals, sharding),
        cols=jax.device_put(cols, sharding),
        rb_bounds=rb_bounds,
        unpad_index=jax.device_put(
            unpad, NamedSharding(mesh, P(None))
        ),
        shape=csr.shape,
        nnz=csr.nnz,
        mesh=mesh,
        nrb_local_max=nrb_local_max,
        ncb=ncb,
    )


def dist_spmm_bsr(
    dm: DistBsrMatrix,
    X: jax.Array,
    x_sharded: bool = False,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Y = A @ X across the mesh (X [ncols, K] replicated, or row-sharded
    and all-gathered inside shard_map)."""
    nrows, ncols = dm.shape
    K = X.shape[1]
    nrb_local = dm.nrb_local_max
    ncb = dm.ncb

    D_shards = dm.n_shards
    xrows = ncb * B
    if x_sharded:
        # pad the row-padded X further to a device multiple; sliced back
        # after the in-shard gather
        xrows = -(-ncb * B // D_shards) * D_shards
    Xp = jnp.pad(X.astype(jnp.float32), ((0, xrows - ncols), (0, 0)))
    x_spec = P(AXIS) if x_sharded else P(None)

    def fn(vals, cols, xs):
        x_full = (
            jax.lax.all_gather(xs, AXIS, tiled=True)[: ncb * B]
            if x_sharded
            else xs
        )
        gx = x_full.reshape(ncb, B, K)[cols[0]]
        Y = jax.lax.dot_general(
            vals[0],
            gx,
            (((1, 3), (1, 2)), ((0,), (0,))),
            precision=precision,
            preferred_element_type=jnp.float32,
        )
        return Y.reshape(nrb_local * B, K)[None]

    mapped = shard_map(
        fn,
        mesh=dm.mesh,
        in_specs=(P(AXIS), P(AXIS), x_spec),
        out_specs=P(AXIS),
    )
    Y_stacked = mapped(dm.vals, dm.cols, Xp)
    return jnp.take(
        Y_stacked.reshape(-1, K), dm.unpad_index, axis=0
    )


def dist_spmm_bsr_jit(dm: DistBsrMatrix, x_sharded: bool = False):
    """A jitted closure over the matrix for iteration-heavy callers."""
    return jax.jit(
        functools.partial(dist_spmm_bsr, dm, x_sharded=x_sharded)
    )
