"""BELL SpMV: one gather-MAC over the k planes + optional SELL spill.

y comes out already in natural row order (no row permutation); the
spill residual (rows deeper than k planes or entries past the reach cap)
adds a SELL SpMV on a matrix that is a few percent of the nnz.  The
gather is offset-bounded, so consecutive rows read neighbouring x
entries and XLA's gather stays in cache.  Reference context: this is the
road domain answer (spmv.cpp:1197-1233, paper Table 3 road_usa 9.57
GFLOPS).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cvr_tpu.formats.bell import BellMatrix
from cvr_tpu.ops.spmv import SellDevice, sell_spmv_xla, to_device


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["li", "vals", "spill", "spill_map"],
    meta_fields=["shape", "d", "pre"],
)
@dataclasses.dataclass(frozen=True)
class BellDevice:
    li: jax.Array  # (k, R_sub, 128) int16
    vals: jax.Array  # (k, R_sub, 128) f32
    spill: SellDevice | None
    spill_map: jax.Array | None  # natural rows of the compressed spill
    shape: tuple
    d: int
    pre: int


def to_device_bell(bm: BellMatrix, device=None) -> BellDevice:
    put = functools.partial(jax.device_put, device=device)
    return BellDevice(
        li=put(bm.li),
        vals=put(bm.vals),
        spill=to_device(bm.spill, device) if bm.spill is not None else None,
        spill_map=(
            put(np.asarray(bm.spill_map, dtype=np.int32))
            if bm.spill_map is not None
            else None
        ),
        shape=bm.shape,
        d=bm.d,
        pre=bm.pre,
    )


def _bell_gather_mac(li, vals, xt, d: int):
    """y rows (R_sub, 128) = sum_p vals[p] * xt[window(li[p])].

    Element (q, lane) of plane p reads x-table row ``8*(q//8) + d +
    (li >> 7)`` at lane ``li & 127``: tile q//8's window starts 8 rows
    further along the table than the previous tile's.
    """
    _, R_sub, _ = li.shape
    idx = li.astype(jnp.int32)
    lo = jnp.bitwise_and(idx, 127)
    hi = jax.lax.shift_right_logical(idx, 7)
    q = jnp.arange(R_sub, dtype=jnp.int32)[None, :, None]
    xt_row = (q // 8) * 8 + d + hi
    gath = jnp.take(xt.reshape(-1), xt_row * 128 + lo)
    return (vals * gath).sum(axis=0)


def spmv_bell(sd: BellDevice, x: jax.Array) -> jax.Array:
    """y = A @ x via BELL planes (+ SELL spill), jit-compatible."""
    nrows, ncols = sd.shape
    R_sub = sd.li.shape[1]
    x = x.astype(jnp.float32)
    # x table: pre zero rows (negative-reach phase) + x + zero tail past
    # the last tile's window (li < 2048 -> at most 16 rows beyond it)
    X = R_sub + 8 + 16
    # in-plane columns never exceed nrows-1 + reach < (X - pre)*128;
    # wide-rectangular tails live in the spill (which sees the full x)
    n_keep = min(ncols, (X - sd.pre) * 128)
    xt = jnp.zeros(X * 128, jnp.float32)
    xt = jax.lax.dynamic_update_slice(xt, x[:n_keep], (sd.pre * 128,))
    y = _bell_gather_mac(sd.li, sd.vals, xt, sd.d).reshape(-1)[:nrows]
    if sd.spill is not None:
        # the spill is row-compressed: add its y back through the map
        y = y.at[sd.spill_map].add(sell_spmv_xla(sd.spill, x), mode="drop")
    return y


def spmm_bell(sd: BellDevice, X: jax.Array) -> jax.Array:
    """Y = A @ X for dense X [ncols, K] via K vmapped BELL SpMVs."""
    return jax.vmap(lambda col: spmv_bell(sd, col), in_axes=1, out_axes=1)(X)
