#!/usr/bin/env python
"""Headline benchmark: SELL-pack SpMV on a web-Google-scale power-law matrix.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, "power_limit": ...}

vs_baseline compares 2*nnz GFLOPS against the reference CVR binary's
webGraph-domain average on its own target hardware (7.28 GFLOPS on a
68-core Xeon Phi KNL, CVR paper Table 3 — see BASELINE.md).

Usage: python bench.py [--quick] [--impl auto|sell|dia|bell|csr]
                       [--iters N] [--json-only]
"""

from __future__ import annotations

import argparse
import json
import sys

# Reference: CVR webGraph domain average, 2*nnz GFLOPS (paper Table 3).
CVR_KNL_WEBGRAPH_GFLOPS = 7.28


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small matrix")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument(
        "--pack-repeats",
        type=int,
        default=1,
        help="pack timing = min over N repeats (first run also reported "
        "when N > 1).  Default 1 = one COLD pack, matching the reference "
        "protocol (spmv.cpp:575,1009 times a single conversion) so the "
        "amortize metric stays comparable to the paper's cold-pack 2.14.",
    )
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)

    # Start faulting the allocator arena now, overlapped with matrix
    # generation and jax/XLA startup (see cvr_tpu/utils/memarena.py).
    from cvr_tpu.utils import memarena

    memarena.warm()

    from cvr_tpu.utils.compilecache import enable as _enable_cache

    _enable_cache()

    from cvr_tpu import platform
    from cvr_tpu.bench.harness import run_spmv_benchmark
    from cvr_tpu.bench.synthetic import rmat_matrix, web_google_like

    if args.quick:
        coo = rmat_matrix(scale=13, edge_factor=8, seed=3)
        name = "rmat13"
        iters = args.iters or 200
    else:
        coo = web_google_like()
        name = "web-Google-like"
        iters = args.iters or 100

    r = run_spmv_benchmark(
        coo,
        name=name,
        impl=args.impl,
        iters=iters,
        pack_repeats=args.pack_repeats,
    )
    if not args.json_only:
        r.print_report()
        print(r.to_json(), file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": f"SpMV GFLOPS (2*nnz) on {name}, {args.impl}",
                "value": round(r.gflops_2nnz, 3),
                "unit": "GFLOPS",
                "vs_baseline": round(
                    r.gflops_2nnz / CVR_KNL_WEBGRAPH_GFLOPS, 3
                ),
                "device": platform.device_info().as_dict(),
                "power_limit": r.power_limit,
            }
        )
    )
    return 0 if (r.verified in (True, None)) else 1


if __name__ == "__main__":
    sys.exit(main())
