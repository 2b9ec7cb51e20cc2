"""Y = A @ X on the BSR-128 artifact: dense-brick SpMM.

Per occupied brick: ``Y[rb*128:(rb+1)*128] += A_brick @ X[cb*128:(cb+1)
*128]`` — a [128,128] x [128,K] dense matmul.  On the device the bricks
of each 128-row block sit side by side, padded with zero bricks to the
widest row block (ELL of bricks), so the whole SpMM is one X-block
gather plus ONE batched dot_general that contracts over a row block's
bricks and their columns at once — no segment-sum.  (The brick-stream +
sorted segment-sum form lowers to an XLA scatter whose kernel on the
H100 failed to launch at K=128 for want of memory.)

Exactness: the matmul runs at ``precision=HIGHEST``, which keeps f32
operands in full f32 on the GPU (DEFAULT would allow TF32, ~1e-3 error).
The verification contract is the SpMV paths' (reference:
spmv.cpp:1916-1938).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cvr_tpu.formats.bsr import B, BsrMatrix, ell_width


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["vals", "cols"],
    meta_fields=["shape", "nnz", "ncb"],
)
@dataclasses.dataclass(frozen=True)
class BsrDevice:
    vals: jax.Array  # (nrb, maxb, B, B) f32: row block's bricks, zero-padded
    cols: jax.Array  # (nrb, maxb) int32 column block of each brick
    shape: tuple[int, int]
    nnz: int
    ncb: int


def brick_ell(brick_row, brick_col, vals, nrb: int):
    """Bricks sorted by row block -> (nrb, maxb) ELL slots (host side).

    Padding slots hold zero bricks pointing at column block 0.
    """
    counts = np.bincount(brick_row, minlength=nrb)
    maxb = ell_width(brick_row, nrb)
    starts = np.zeros(nrb, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot = np.arange(brick_row.shape[0]) - starts[brick_row]
    ell_vals = np.zeros((nrb, maxb, B, B), dtype=np.float32)
    ell_cols = np.zeros((nrb, maxb), dtype=np.int32)
    ell_vals[brick_row, slot] = vals
    ell_cols[brick_row, slot] = brick_col
    return ell_vals, ell_cols


def to_device_bsr(bm: BsrMatrix, device=None) -> BsrDevice:
    put = functools.partial(jax.device_put, device=device)
    nrb = max(1, _round_up(bm.shape[0], B) // B)
    vals, cols = brick_ell(bm.brick_row, bm.brick_col, bm.vals, nrb)
    return BsrDevice(
        vals=put(vals),
        cols=put(cols),
        shape=bm.shape,
        nnz=bm.nnz,
        ncb=max(1, _round_up(bm.shape[1], B) // B),
    )


def spmm_bsr(
    dev: BsrDevice,
    X: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Y = A @ X for dense X [ncols, K] (precision=HIGHEST: full f32)."""
    nrows, ncols = dev.shape
    K = X.shape[1]
    nrb = dev.vals.shape[0]
    Xp = jnp.pad(
        X.astype(jnp.float32), ((0, dev.ncb * B - ncols), (0, 0))
    ).reshape(dev.ncb, B, K)
    gx = Xp[dev.cols]  # (nrb, maxb, B, K) block gather
    Y = jax.lax.dot_general(
        dev.vals,
        gx,
        (((1, 3), (1, 2)), ((0,), (0,))),
        precision=precision,
        preferred_element_type=jnp.float32,
    )  # (nrb, B, K)
    return Y.reshape(nrb * B, K)[:nrows]
