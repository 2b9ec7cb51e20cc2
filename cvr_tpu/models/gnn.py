"""Graph neural-network layers driven by the SpMM kernels.

The reference is a pure SpMV/SpMM benchmark; the modern production
payload for exactly its matrix class (power-law web/social adjacency,
CVR paper Table 2) is graph neural networks, where every layer is one
SpMM against a dense feature block — the BASELINE "8-64 RHS" range is
precisely a GCN hidden width.  These layers are thin, jit-traceable
compositions over a caller-supplied ``spmm`` closure, so any packed
format (BSR bricks, SELL, DIA, BELL — cvr_tpu.ops.spmv.spmm) slots in
unchanged.

Design notes:
  * feature transforms are ordered ``A @ (X @ W)`` when W shrinks the
    feature width and ``(A @ X) @ W`` otherwise — the SpMM is the
    expensive factor, so it always runs at the narrower K;
  * symmetric normalization D^-1/2 A D^-1/2 is folded into the packed
    values at build time (``gcn_normalize``), not applied per step —
    the reference analogue is CVR folding structure into the packed
    format once (reference spmv.cpp:565-1014) so the hot loop stays
    branch-free.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["gcn_normalize", "gcn_layer", "gcn_forward", "graphsage_layer"]


def gcn_normalize(rows, cols, vals, nrows: int, add_self_loops: bool = True):
    """Fold GCN symmetric normalization into COO values (host-side).

    Returns (rows, cols, vals) for Â = D^-1/2 (A + I) D^-1/2 — the
    Kipf-Welling propagation operator — ready for any packer.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if add_self_loops:
        rows = np.concatenate([rows, np.arange(nrows, dtype=np.int64)])
        cols = np.concatenate([cols, np.arange(nrows, dtype=np.int64)])
        vals = np.concatenate([vals, np.ones(nrows)])
    # degree from |weights|: identical to the standard D = sum(A) on
    # nonnegative adjacency, and keeps D^-1/2 bounded (<= 1 with self
    # loops) on signed inputs instead of overflowing f32 downstream
    deg = np.zeros(nrows, dtype=np.float64)
    np.add.at(deg, rows, np.abs(vals))
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-30))
    return (
        rows.astype(np.int32),
        cols.astype(np.int32),
        (vals * dinv[rows] * dinv[cols]).astype(np.float32),
    )


def gcn_layer(spmm, X: jax.Array, W: jax.Array, b=None, activation=jax.nn.relu):
    """One GCN layer: activation(Â @ X @ W + b).

    spmm: closure Y = Â @ M for dense M [n, k] over the packed Â.
    The matmul order minimizes the SpMM width (see module doc).
    """
    fin, fout = W.shape
    # the feature matmuls are tiny next to the SpMM; run them at
    # HIGHEST (full f32) so a DEFAULT-precision matmul's reduced-precision
    # operands (TF32 on the GPU) don't cap layer accuracy
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    if fout <= fin:
        H = spmm(mm(jnp.asarray(X, jnp.float32), W))
    else:
        H = mm(spmm(jnp.asarray(X, jnp.float32)), W)
    if b is not None:
        H = H + b
    return activation(H) if activation is not None else H


def gcn_forward(spmm, X: jax.Array, weights, biases=None):
    """Multi-layer GCN forward: ReLU between layers, linear last layer."""
    H = jnp.asarray(X, jnp.float32)
    nl = len(weights)
    for i, W in enumerate(weights):
        b = biases[i] if biases is not None else None
        act = jax.nn.relu if i < nl - 1 else None
        H = gcn_layer(spmm, H, W, b=b, activation=act)
    return H


def graphsage_layer(
    spmm_mean, X: jax.Array, W_self: jax.Array, W_neigh: jax.Array,
    activation=jax.nn.relu,
):
    """GraphSAGE-mean layer: act(X @ W_self + (D^-1 A @ X) @ W_neigh).

    spmm_mean: closure over the ROW-normalized adjacency (fold D^-1
    into packed values, same pattern as gcn_normalize).
    """
    X = jnp.asarray(X, jnp.float32)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    H = mm(X, W_self) + mm(spmm_mean(X), W_neigh)
    return activation(H) if activation is not None else H
