#!/usr/bin/env python
"""SpMM benchmark: the BSR-128 dense-brick path vs the gather formats.

BASELINE.json config 4 ("SpMM, 8-64 RHS").  The reference has no SpMM;
the honest comparison is against this framework's own gather SpMM on
the format pack_auto picks (SELL, DIA or BELL).

Each run is verified against a float64 scipy golden on a random RHS.

Usage: python scripts/spmm_bench.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def bench_one(name, coo, K, precision, iters=20):
    import jax.numpy as jnp

    from cvr_tpu.bench.harness import time_fn_iterated
    from cvr_tpu.formats.bsr import bsr_pack
    from cvr_tpu.ops.spmm_bsr import spmm_bsr, to_device_bsr

    csr = coo.to_csr()
    t0 = time.perf_counter()
    bm = bsr_pack(csr)
    pack_s = time.perf_counter() - t0
    dev = to_device_bsr(bm)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((csr.shape[1], K)).astype(np.float32)

    # verify on a thin slice (float64 golden, scaled backward error)
    m64 = csr.to_scipy().astype(np.float64)
    Xv = X[:, : min(K, 8)]
    Y = np.asarray(spmm_bsr(dev, jnp.asarray(Xv), precision=precision))
    gold = m64 @ Xv.astype(np.float64)
    scale = abs(m64) @ np.abs(Xv.astype(np.float64)) + 1e-30
    maxrel = float((np.abs(Y - gold) / scale).max())

    fn = lambda A, V: spmm_bsr(A, V, precision=precision)
    t = time_fn_iterated(fn, dev, jnp.asarray(X), iters, scale=0.05)
    row = {
        "name": name,
        "impl": f"bsr-{str(precision).split('.')[-1].lower()}",
        "K": K,
        "nnz": csr.nnz,
        "nbricks": bm.nbricks,
        "fill": round(bm.fill, 4),
        "pack_s": round(pack_s, 3),
        "spmm_s": t,
        "useful_gflops": round(2 * csr.nnz * K / t / 1e9, 1),
        "max_rel_err": maxrel,
    }
    print(json.dumps(row))
    return row


def bench_auto(name, coo, K, iters=5):
    """The gather-format SpMM on what pack_auto picks."""
    import jax.numpy as jnp

    from cvr_tpu.bench.harness import time_fn_iterated
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.ops.spmv import spmm_fn_of

    csr = coo.to_csr()
    packed = pack_auto(csr)
    A, fn = spmm_fn_of(packed)
    X = (
        np.random.default_rng(0)
        .standard_normal((csr.shape[1], K))
        .astype(np.float32)
    )
    t = time_fn_iterated(fn, A, jnp.asarray(X), iters, scale=0.05)
    row = {
        "name": name,
        "impl": f"auto:{type(packed).__name__}",
        "K": K,
        "nnz": csr.nnz,
        "spmm_s": t,
        "useful_gflops": round(2 * csr.nnz * K / t / 1e9, 1),
    }
    print(json.dumps(row))
    return row


def main():
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/spmm_bench.jsonl")
    args = ap.parse_args()

    from cvr_tpu.bench.synthetic import (
        banded_matrix,
        fem_like,
        rgg_like,
        web_google_like,
    )

    P = jax.lax.Precision
    rows = []
    if args.quick:
        coo = banded_matrix(200_000, bandwidth=27, seed=0)
        rows.append(bench_one("banded-200K", coo, 128, P.HIGHEST))
    else:
        web = web_google_like()
        for K in (32, 64, 128):
            rows.append(bench_auto("web-Google-like", web, K))
        del web
        banded = banded_matrix(1_000_000, bandwidth=27, seed=0)
        for K in (32, 128, 256):
            rows.append(bench_one("banded-1M", banded, K, P.HIGHEST))
        rows.append(bench_one("banded-1M", banded, 128, P.HIGH))
        for K in (32, 128):
            rows.append(bench_auto("banded-1M", banded, K))
        del banded
        rows.append(bench_one("fem-like", fem_like(), 128, P.HIGHEST))
        rows.append(
            bench_one("rgg-like", rgg_like(n=1 << 20), 128, P.HIGHEST)
        )
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
