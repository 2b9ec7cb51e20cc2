"""y = A @ x (and Y = A @ X) on the DIA artifact: shifted streaming FMAs.

Each diagonal contributes ``band_k * x[r + off_k]`` — a static slice of a
zero-padded x, so the whole SpMV is nd fused elementwise FMAs with zero
gathers.  XLA fuses the slices into one streaming loop; it is
HBM-bandwidth bound by the band planes (4 B/nnz), the roofline the other
formats can only approach.  (Reference best case: CVR's pure-streaming
phase 3 on regular rows, spmv.cpp:1351-1437.)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from cvr_tpu.formats.dia import DiaMatrix


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["bands"],
    meta_fields=["offsets", "shape", "nnz"],
)
@dataclasses.dataclass(frozen=True)
class DiaDevice:
    bands: jax.Array  # (nd, nrows) f32
    offsets: tuple  # static python ints -> static slice starts
    shape: tuple[int, int]
    nnz: int


def to_device_dia(dm: DiaMatrix, device=None) -> DiaDevice:
    return DiaDevice(
        bands=jax.device_put(dm.bands, device=device),
        offsets=tuple(int(o) for o in dm.offsets),
        shape=dm.shape,
        nnz=dm.nnz,
    )


def spmv_dia(sd: DiaDevice, x: jax.Array) -> jax.Array:
    """y = A @ x as nd shifted FMAs over a zero-padded x (one fusion)."""
    nrows, ncols = sd.shape
    lo = min(sd.offsets + (0,))
    hi = max(sd.offsets + (0,))
    # pad so every shifted slice is in-bounds: xp[i] = x[i - (-lo)]
    xp = jnp.pad(
        x.astype(jnp.float32), (max(-lo, 0), max(nrows + hi - ncols, 0))
    )
    y = jnp.zeros(nrows, jnp.float32)
    base = max(-lo, 0)
    for k, off in enumerate(sd.offsets):
        y = y + sd.bands[k] * jax.lax.dynamic_slice_in_dim(
            xp, base + off, nrows
        )
    return y


def spmm_dia(sd: DiaDevice, X: jax.Array) -> jax.Array:
    """Y = A @ X for dense X [ncols, K]: shifted FMAs over padded X rows."""
    nrows, ncols = sd.shape
    lo = min(sd.offsets + (0,))
    hi = max(sd.offsets + (0,))
    Xp = jnp.pad(
        X.astype(jnp.float32),
        ((max(-lo, 0), max(nrows + hi - ncols, 0)), (0, 0)),
    )
    Y = jnp.zeros((nrows, X.shape[1]), jnp.float32)
    base = max(-lo, 0)
    for k, off in enumerate(sd.offsets):
        Y = Y + sd.bands[k][:, None] * jax.lax.dynamic_slice_in_dim(
            Xp, base + off, nrows, axis=0
        )
    return Y
