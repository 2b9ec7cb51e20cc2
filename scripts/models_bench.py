#!/usr/bin/env python
"""Flagship model benchmarks: PageRank and CG on the packed formats.

The reference is a pure SpMV benchmark; its real payload is iterative
graph/solver kernels.  This script runs them end-to-end on one chip:

  * PageRank on the web-Google-scale power-law graph (SELL format) —
    the workload class the CVR paper motivates with (Table 2);
  * conjugate gradient on an SPD banded system (the format pack_auto
    picks, DIA) — the EngSci-domain payload.

Prints the greppable contract lines plus per-iteration timing.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def bench_pagerank(iters: int) -> None:
    import jax
    import jax.numpy as jnp

    from cvr_tpu.bench.synthetic import web_google_like
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.models.pagerank import pagerank
    from cvr_tpu.ops.spmv import spmv_fn_of

    coo = web_google_like()
    coo.vals = np.ones_like(coo.vals)  # adjacency: unweighted links
    csr_t = coo.transpose().to_csr()  # PageRank follows in-links: A^T
    nrows = csr_t.shape[0]
    out_degree = np.zeros(nrows, dtype=np.float32)
    np.add.at(out_degree, coo.rows.astype(np.int64), 1.0)

    t0 = time.perf_counter()
    sd, spmv_fn = spmv_fn_of(pack_auto(csr_t))
    pack_s = time.perf_counter() - t0
    odeg = jnp.asarray(out_degree)

    def run(max_iters, damping):
        return pagerank(
            lambda p: spmv_fn(sd, p),
            nrows,
            damping=damping,
            tol=0.0,
            max_iters=max_iters,
            out_degree=odeg,
        )

    runj = jax.jit(run, static_argnums=0)

    # per-iteration time via the slope between two loop lengths
    def wall(k):
        t0 = time.perf_counter()
        jax.block_until_ready(runj(k, jnp.float32(0.85)))
        return time.perf_counter() - t0
    _ = wall(iters)  # compile both lengths
    _ = wall(5 * iters)
    per_iter = (min(wall(5 * iters), wall(5 * iters))
                - min(wall(iters), wall(iters))) / (4 * iters)
    ranks, its, delta = runj(iters, jnp.float32(0.85))
    ranks_np = np.asarray(ranks)
    top = np.argsort(-ranks_np)[:5]
    print(
        f"[model: pagerank] [matrix: web-Google-like] "
        f"pack {pack_s:.1f}s, {per_iter * 1e3:.2f} ms/iteration, "
        f"final delta after {iters} iters {float(delta):.2e}"
    )
    print(
        f"[model: pagerank] top ranks {ranks_np[top].round(7).tolist()} "
        f"sum {ranks_np.sum():.6f}"
    )
    assert abs(ranks_np.sum() - 1.0) < 1e-3


def bench_cg(iters: int) -> None:
    import jax
    import jax.numpy as jnp

    from cvr_tpu.bench.synthetic import banded_matrix
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.models.solvers import conjugate_gradient
    from cvr_tpu.ops.spmv import spmv_fn_of

    # SPD system: A = B + B^T + diag(band weight) on a 1M band
    n = 1 << 20
    band = banded_matrix(n, bandwidth=13, seed=5)
    sym = COOMatrix(
        rows=np.concatenate([band.rows, band.cols]),
        cols=np.concatenate([band.cols, band.rows]),
        vals=np.concatenate([band.vals, band.vals]),
        shape=(n, n),
    ).sum_duplicates()
    # diagonal dominance => SPD
    row_abs = np.zeros(n, dtype=np.float64)
    np.add.at(row_abs, sym.rows.astype(np.int64), np.abs(sym.vals))
    diag = COOMatrix(
        rows=np.arange(n, dtype=np.int32),
        cols=np.arange(n, dtype=np.int32),
        vals=(row_abs + 1.0).astype(np.float32),
        shape=(n, n),
    )
    spd = COOMatrix(
        rows=np.concatenate([sym.rows, diag.rows]),
        cols=np.concatenate([sym.cols, diag.cols]),
        vals=np.concatenate([sym.vals, diag.vals]),
        shape=(n, n),
    ).sum_duplicates()
    csr = spd.to_csr()

    t0 = time.perf_counter()
    sd, spmv_fn = spmv_fn_of(pack_auto(csr))
    pack_s = time.perf_counter() - t0

    b = jnp.asarray(
        np.random.default_rng(0).standard_normal(n).astype(np.float32)
    )

    # Timing: a CG-shaped fori loop (no early exit; the library CG's
    # while_loop stops once converged — this system reaches rs == 0 in
    # ~20 iterations — which flattens any slope measurement).  Guarded
    # denominators keep iterating stably past convergence.
    def cg_shaped(scale, k):
        bb = b * scale
        xv = jnp.zeros_like(bb)
        r = bb
        p = r
        rs = jnp.vdot(r, r)

        def body(i, st):
            xv, r, p, rs = st
            Ap = spmv_fn(sd, p)
            alpha = rs / (jnp.vdot(p, Ap) + 1e-30)
            xv = xv + alpha * p
            r = r - alpha * Ap
            rs2 = jnp.vdot(r, r)
            p = r + (rs2 / (rs + 1e-30)) * p
            return xv, r, p, rs2

        xv, r, p, rs = jax.lax.fori_loop(0, k, body, (xv, r, p, rs))
        return jnp.sum(xv)

    timej = jax.jit(cg_shaped)

    def wall(k):
        t0 = time.perf_counter()
        jax.block_until_ready(timej(jnp.float32(1.0), jnp.int32(k)))
        return time.perf_counter() - t0

    _ = wall(2)  # compile
    _ = wall(iters)
    per_iter = (min(wall(5 * iters), wall(5 * iters))
                - min(wall(iters), wall(iters))) / (4 * iters)
    runj = jax.jit(
        lambda t: conjugate_gradient(
            lambda v: spmv_fn(sd, v), b, tol=t, max_iters=1000
        )
    )
    x, its, res = runj(jnp.float32(1e-6))
    x_np = np.asarray(x)
    conv_iters = int(its)
    # true residual on host (float64)
    from cvr_tpu.ops.spmv_ref import spmv_golden_numpy

    r = np.asarray(b, dtype=np.float64) - spmv_golden_numpy(csr, x_np)
    rel = np.linalg.norm(r) / np.linalg.norm(np.asarray(b))
    print(
        f"[model: cg] [matrix: spd-banded-1M, nnz {csr.nnz}] "
        f"pack {pack_s:.1f}s, {per_iter * 1e3:.2f} ms/iteration, "
        f"converges to 1e-6 in {conv_iters} iters, "
        f"true rel residual at convergence {rel:.2e}"
    )
    assert rel < 1e-4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pagerank-iters", type=int, default=50)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--only", choices=["pagerank", "cg"], default=None)
    args = ap.parse_args()
    if args.only in (None, "pagerank"):
        bench_pagerank(args.pagerank_iters)
    if args.only in (None, "cg"):
        bench_cg(args.cg_iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
