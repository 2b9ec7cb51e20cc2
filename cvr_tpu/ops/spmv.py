"""SpMV / SpMM on the SELL-pack format — XLA-native path and dispatcher.

The XLA path expresses the whole SpMV as three fusable dense ops over the
slot-major planes:

    contrib   = vals_plane * x[cols_plane]          # gather + FMA   [S, C]
    y_sorted  = segment_sum(contrib, slot_slice)    # per-slice sum  [n, C]
    y         = y_sorted.ravel()[row_rank]          # un-permute     [nrows]

Because rows were length-sorted at pack time, every lane of a slice carries
near-identical work — the load-balance property CVR achieves with its
record/steal machinery (ref: spmv.cpp:808-1000) is already in the data
layout, so no scalar drains, atomics (ref: spmv.cpp:1280-1282) or
calibrator passes (csr5_spmv_avx512.h:291-308) exist at compute time.

``spmv``/``spmm`` dispatch on the packed format's type.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.formats.sell import SellMatrix


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["vals_plane", "cols_plane", "slot_slice", "out_index"],
    meta_fields=["nslices", "nrows", "has_splits"],
)
@dataclasses.dataclass(frozen=True)
class SellDevice:
    """Device-resident SELL-pack planes (a pytree of jax.Arrays).

    It holds only the arrays an SpMV reads, so its bytes are the bytes one
    product streams.  ``out_index`` maps the per-segment partials to y:
    without splits it is the pack's ``row_rank`` and the combine is a
    gather; with splits (long rows segmented at pack time, ``has_splits``)
    it is ``perm`` and the combine is a scatter-add.
    """

    vals_plane: jax.Array  # [S, C]
    cols_plane: jax.Array  # [S, C] int32
    slot_slice: jax.Array  # [S] int32
    out_index: jax.Array  # [nrows] row_rank, or [nslices * C] perm
    nslices: int
    nrows: int
    has_splits: bool

    @property
    def C(self) -> int:
        return self.vals_plane.shape[1]


def to_device(sm: SellMatrix, device=None) -> SellDevice:
    put = functools.partial(jax.device_put, device=device)
    has_splits = sm.n_splits > 0
    return SellDevice(
        vals_plane=put(sm.vals_plane),
        cols_plane=put(sm.cols_plane),
        slot_slice=put(sm.slot_slice),
        out_index=put(sm.perm if has_splits else sm.row_rank),
        nslices=sm.nslices,
        nrows=sm.shape[0],
        has_splits=has_splits,
    )


def _combine(sd: SellDevice, y_sorted_flat: jax.Array) -> jax.Array:
    """Per-segment partials -> y, matching the pack-time layout.

    No splits: pure gather through row_rank.  With splits: scatter-add the
    partials of each row's segments through perm (the AOT analogue of
    CVR's omp-atomic tail flush, spmv.cpp:1631-1651).  Padding positions
    carry partial 0 and are routed to a sentinel row that is sliced off.
    """
    if not sd.has_splits:
        return jnp.take(y_sorted_flat, sd.out_index, axis=0)
    nrows = sd.nrows
    zeros = jnp.zeros((nrows + 1,) + y_sorted_flat.shape[1:], y_sorted_flat.dtype)
    return zeros.at[sd.out_index].add(y_sorted_flat)[:nrows]


def sell_spmv_xla(sd: SellDevice, x: jax.Array) -> jax.Array:
    """y = A @ x on the SELL-pack planes, pure XLA.

    The one SELL SpMV: on the H100 it beat a hand-written Triton SELL
    kernel end to end on web-Google-like and soc-LiveJournal-full-like
    (docs/DESIGN.md, "Hopper").
    """
    contrib = sd.vals_plane * jnp.take(x, sd.cols_plane, axis=0)
    y_sorted = jax.ops.segment_sum(
        contrib,
        sd.slot_slice,
        num_segments=sd.nslices,
        indices_are_sorted=True,
    )
    return _combine(sd, y_sorted.reshape(-1))


def sell_spmm_xla(sd: SellDevice, X: jax.Array) -> jax.Array:
    """Y = A @ X for a dense block of K right-hand sides (X: [ncols, K]).

    Multi-RHS SpMV (BASELINE.json config #4): each gathered X row is K
    contiguous words, so one column index serves K multiply-adds.
    """
    gathered = jnp.take(X, sd.cols_plane, axis=0)  # [S, C, K]
    contrib = sd.vals_plane[..., None] * gathered
    y_sorted = jax.ops.segment_sum(
        contrib,
        sd.slot_slice,
        num_segments=sd.nslices,
        indices_are_sorted=True,
    )  # [nslices, C, K]
    flat = y_sorted.reshape(-1, X.shape[1])
    return _combine(sd, flat)


# ---------------------------------------------------------------------------
# High-level dispatchers
# ---------------------------------------------------------------------------


def _formats():
    """host type -> (device type, to_device, spmv, spmm); spmv None for
    SpMM-only formats."""
    from cvr_tpu.formats.bell import BellMatrix
    from cvr_tpu.formats.bsr import BsrMatrix
    from cvr_tpu.formats.dia import DiaMatrix
    from cvr_tpu.ops import spmm_bsr, spmv_bell, spmv_dia

    return {
        SellMatrix: (SellDevice, to_device, sell_spmv_xla, sell_spmm_xla),
        DiaMatrix: (
            spmv_dia.DiaDevice, spmv_dia.to_device_dia,
            spmv_dia.spmv_dia, spmv_dia.spmm_dia,
        ),
        BellMatrix: (
            spmv_bell.BellDevice, spmv_bell.to_device_bell,
            spmv_bell.spmv_bell, spmv_bell.spmm_bell,
        ),
        BsrMatrix: (
            spmm_bsr.BsrDevice, spmm_bsr.to_device_bsr, None,
            spmm_bsr.spmm_bsr,
        ),
    }


def _entry(A):
    for host, entry in _formats().items():
        if isinstance(A, (host, entry[0])):
            return entry
    raise TypeError(f"unsupported matrix type {type(A)}")


def _fn_of(packed, col: int):
    dev_type, to_dev, *fns = _entry(packed)
    if fns[col] is None:
        raise TypeError(f"{type(packed).__name__} has no SpMV; use spmm")
    sd = packed if isinstance(packed, dev_type) else to_dev(packed)
    return sd, fns[col]


def spmv_fn_of(packed):
    """(device artifact, un-jitted SpMV fn) for a packed matrix (host or
    device form) — what benchmark loops iterate."""
    return _fn_of(packed, 0)


def spmm_fn_of(packed):
    """(device artifact, un-jitted SpMM fn) for a packed matrix."""
    return _fn_of(packed, 1)


@functools.lru_cache(maxsize=None)
def _jitted(fn):
    return jax.jit(fn)


def _csr_spmv(A: CSRMatrix, x):
    from cvr_tpu.ops.spmv_ref import spmv_csr_jnp

    return spmv_csr_jnp(
        jnp.asarray(A.rowptr), jnp.asarray(A.cols), jnp.asarray(A.vals),
        x, A.shape[0],
    )


def spmv(A, x):
    """y = A @ x.  A may be a SellMatrix / SellDevice, DiaMatrix /
    DiaDevice, BellMatrix / BellDevice or CSRMatrix."""
    x = jnp.asarray(x)
    if isinstance(A, CSRMatrix):
        return _csr_spmv(A, x)
    sd, fn = spmv_fn_of(A)
    return _jitted(fn)(sd, x)


def spmm(A, X):
    """Y = A @ X for dense X [ncols, K].

    BsrMatrix/BsrDevice inputs run the dense-brick path
    (cvr_tpu/ops/spmm_bsr.py: one batched f32 matmul at HIGHEST
    precision); pack with ``cvr_tpu.bsr_pack``.  SELL inputs gather X
    rows in plane order (``sell_spmm_xla``); DIA runs shifted FMAs and
    BELL K vmapped gather-MACs.
    """
    X = jnp.asarray(X)
    if isinstance(A, CSRMatrix):
        return jax.vmap(lambda col: _csr_spmv(A, col), in_axes=1, out_axes=1)(X)
    sd, fn = spmm_fn_of(A)
    return _jitted(fn)(sd, X)
