"""PageRank on a SELL-packed adjacency matrix.

The reference is a pure SpMV benchmark; its real-world payload is exactly
this class of iterative graph kernels on power-law matrices (the CVR
paper's motivating datasets are web graphs and social networks, Table 2).
PageRank here is the flagship "model": repeated SpMV under jit with
compiler-friendly control flow (lax.while_loop, static shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def pagerank(
    matvec,
    nrows: int,
    damping: float = 0.85,
    tol: float = 1e-8,
    max_iters: int = 100,
    out_degree=None,
):
    """Power-method PageRank.

    matvec: y = A^T_normalized @ p callable (jit-traceable), where the
    caller provides the link-following operator — typically
    ``lambda p: spmv(A_T, p / out_degree)`` for adjacency A.
    out_degree: optional [nrows] array; if given, matvec receives the raw
    rank vector and the normalization (+ dangling-mass redistribution)
    happens here.

    Returns (ranks [nrows], iterations, final_delta).
    """

    def normalized_matvec(p):
        if out_degree is None:
            return matvec(p)
        deg = jnp.maximum(out_degree, 1)
        contrib = jnp.where(out_degree > 0, p / deg, 0.0)
        spread = matvec(contrib)
        dangling = jnp.sum(jnp.where(out_degree == 0, p, 0.0))
        return spread + dangling / nrows

    p0 = jnp.full((nrows,), 1.0 / nrows, dtype=jnp.float32)

    def cond(state):
        _, delta, it = state
        return jnp.logical_and(delta > tol, it < max_iters)

    def body(state):
        p, _, it = state
        p_new = (1.0 - damping) / nrows + damping * normalized_matvec(p)
        # L1 normalize to counter FP drift.
        p_new = p_new / jnp.sum(jnp.abs(p_new))
        delta = jnp.sum(jnp.abs(p_new - p))
        return p_new, delta, it + 1

    p, delta, iters = jax.lax.while_loop(
        cond, body, (p0, jnp.float32(jnp.inf), jnp.int32(0))
    )
    return p, iters, delta


def pagerank_sell(sd, *, transposed_sd=None, **kwargs):
    """Convenience wrapper: PageRank on a SellDevice adjacency matrix.

    PageRank needs A^T @ p; pass ``transposed_sd`` packed from the
    transposed adjacency (cheap at build time: swap rows/cols in COO).
    """
    from cvr_tpu.ops.spmv import sell_spmv_xla

    A = transposed_sd if transposed_sd is not None else sd
    nrows = A.nrows
    return jax.jit(
        functools.partial(
            pagerank, lambda p: sell_spmv_xla(A, p), nrows, **kwargs
        )
    )()
