#!/usr/bin/env python
"""Benchmark sweep runner — the run_comparison.sh analogue.

Runs every implementation over a suite of matrices (local .mtx files
and/or synthetic generators), appends results.csv / results.jsonl, and
prints the greppable per-run contract plus a final summary table.

Usage:
  python scripts/sweep.py                      # default synthetic suite
  python scripts/sweep.py --mtx a.mtx b.mtx    # explicit files
  python scripts/sweep.py --iters 200 --impls sell,csr
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def default_suite():
    """Synthetic stand-ins for the CGO'18 suite domains (paper Table 2):
    web graph, social-ish denser power-law, and an HPC band stencil."""
    from cvr_tpu.bench.synthetic import banded_matrix, rmat_matrix

    return [
        ("rmat16-web", lambda: rmat_matrix(scale=16, edge_factor=6, seed=1)),
        ("rmat16-social", lambda: rmat_matrix(scale=16, edge_factor=16, seed=2)),
        ("banded-1M", lambda: banded_matrix(1 << 20, bandwidth=27)),
    ]


def cgo18_suite():
    """Full-scale stand-ins for the eight CGO'18 headline domains
    (paper Table 2/3).  Reference CVR domain averages (2nnz GFLOPS, KNL
    7250): webGraph 7.28, social 6.59, wiki 5.77, citation 6.26,
    road 9.57, routing 17.11, FSM 8.09, EngSci 21.11."""
    from cvr_tpu.bench.synthetic import (
        banded_matrix,
        citation_like,
        fem_like,
        fsm_like,
        rgg_like,
        road_usa_like,
        soc_livejournal_like,
        web_google_like,
        wiki_talk_like,
    )

    def real_or(name, group, fallback):
        """Use a genuine cached SuiteSparse matrix when present (offline
        cache, io/suitesparse.py); otherwise the synthetic stand-in."""
        def load():
            try:
                from cvr_tpu.io.suitesparse import load_suitesparse

                return load_suitesparse(name, group=group)
            except FileNotFoundError:
                return fallback()
        return load

    from cvr_tpu.bench.synthetic import (
        citation_like_b,
        fem_like_b,
        fsm_like_b,
        rgg_like_b,
        road_usa_like_b,
        soc_livejournal_like_b,
        web_google_like_b,
        wiki_talk_like_b,
    )

    # two structurally distinct stand-ins per paper domain: a domain's
    # score is the MIN over its matrices, not one seed's luck
    return [
        ("web-Google-like",
         real_or("web-Google", "SNAP", web_google_like)),  # webGraph: 7.28
        ("web-rmat-b", web_google_like_b),
        ("soc-LJ-like",
         real_or("soc-LiveJournal1", "SNAP", soc_livejournal_like)),  # social: 6.59
        ("soc-rmat-b", soc_livejournal_like_b),
        ("wiki-Talk-like",
         real_or("wiki-Talk", "SNAP", wiki_talk_like)),    # wiki:     5.77
        ("wiki-hub-b", wiki_talk_like_b),
        ("citation-like",
         real_or("cit-Patents", "SNAP", citation_like)),   # citation: 6.26
        ("citation-b", citation_like_b),
        ("road-usa-like",
         real_or("road_usa", "DIMACS10", road_usa_like)),  # road:     9.57
        ("road-b", road_usa_like_b),
        ("rgg-like", rgg_like),                            # routing: 17.11
        ("rgg-b", rgg_like_b),
        ("fsm-like", fsm_like),                            # FSM:      8.09
        ("fsm-b", fsm_like_b),
        ("fem-like", fem_like),                            # EngSci:  21.11
        ("fem-b", fem_like_b),
        ("banded-2M", lambda: banded_matrix(1 << 21, bandwidth=27)),
    ]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mtx", nargs="*", default=None)
    ap.add_argument("--impls", default="auto,sell,csr")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default="results.csv")
    ap.add_argument(
        "--full", action="store_true", help="full-scale CGO'18 suite"
    )
    ap.add_argument(
        "--pack-repeats",
        type=int,
        default=1,
        help="pack timing = min over N in-process repeats "
        "(first run also recorded; see bench harness)",
    )
    args = ap.parse_args()

    from cvr_tpu.utils import memarena

    memarena.warm()

    from cvr_tpu.bench.harness import run_spmv_benchmark
    from cvr_tpu.io.mmio import read_matrix_market
    from cvr_tpu.utils.report import append_jsonl, append_result

    if args.mtx:
        suite = [(p, (lambda p=p: read_matrix_market(p))) for p in args.mtx]
    elif args.full:
        suite = cgo18_suite()
    else:
        suite = default_suite()

    rows = []
    for name, load in suite:
        coo = load()
        for impl in args.impls.split(","):
            try:
                r = run_spmv_benchmark(
                    coo,
                    name=name,
                    impl=impl,
                    iters=args.iters,
                    pack_repeats=args.pack_repeats,
                )
            except Exception as e:  # noqa: BLE001 — finish the sweep
                print(f"[{name}/{impl}] FAILED: {type(e).__name__}: {e}")
                continue
            r.print_report(threads_label=impl)
            append_result(r, args.out)
            append_jsonl(r, Path(args.out).with_suffix(".jsonl"))
            rows.append(r)

    if rows:
        print("\n=== summary (GFLOPS 2*nnz) ===")
        for r in rows:
            v = "PASS" if r.verified else ("n/a" if r.verified is None else "FAIL")
            print(
                f"{r.name:16s} {r.impl:12s} {r.gflops_2nnz:10.3f}  "
                f"preproc {r.preproc_s * 1e3:9.1f} ms  verify {v}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
