"""Command-line driver.

Reproduces the reference's UX — ``./spmv.cvr <file.mtx> <threads> <iters>``
(spmv.cpp:1693-1712, README.md:26-28) — as subcommands:

  python -m cvr_tpu.cli spmv <file.mtx> [--iters N]
      [--format auto|bell|dia|sell|csr|bsr]
      [--rhs K] [--c C]
      [--sigma S] [--no-verify]
      [--save-packed out.npz] [--load-packed in.npz]
  python -m cvr_tpu.cli compare <file.mtx> [--iters N] [--rhs K]
  python -m cvr_tpu.cli info <file.mtx>

``compare`` runs every implementation on the same matrix and prints the
greppable metric table, mirroring run_comparison.sh.  ``--threads`` is
accepted for reference CLI compatibility and ignored (parallelism on the
GPU comes from the device, not a thread count).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _load(path: str, pattern_values: str):
    from cvr_tpu.io.mmio import read_matrix_market

    t0 = time.perf_counter()
    coo = read_matrix_market(path, pattern_values=pattern_values)
    print(
        f"[file: {path}] read {coo.shape[0]}x{coo.shape[1]}, "
        f"{coo.nnz} nnz in {time.perf_counter() - t0:.2f}s"
    )
    return coo


def cmd_spmv(args) -> int:
    from cvr_tpu.bench.harness import run_spmv_benchmark

    coo = _load(args.matrix, args.pattern_values)

    if args.rhs > 1:
        return _spmm(args, coo)

    if args.format == "bsr":
        print(
            "error: --format bsr is an SpMM format (dense 128x128 "
            "bricks); use it with --rhs K > 1",
            file=sys.stderr,
        )
        return 2

    if args.load_packed:
        return _spmv_prepacked(args, coo)

    r = run_spmv_benchmark(
        coo,
        name=args.matrix,
        impl=args.format,
        iters=args.iters,
        C=args.c,
        sigma=args.sigma,
        verify_result=not args.no_verify,
    )
    r.print_report()
    if args.save_packed:
        _save_packed(args, coo.to_csr())
        print(f"packed artifact saved to {args.save_packed}")
    return 0 if r.verified in (True, None) else 1


def _save_packed(args, csr) -> None:
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.bell import BellMatrix, bell_pack, save_bell
    from cvr_tpu.formats.dia import dia_pack
    from cvr_tpu.formats.sell import DEFAULT_C, sell_pack

    packed = {
        "auto": lambda: pack_auto(csr),
        "bell": lambda: bell_pack(csr),
        "dia": lambda: dia_pack(csr),
        "sell": lambda: sell_pack(csr, C=args.c or DEFAULT_C, sigma=args.sigma),
    }[args.format]()
    if isinstance(packed, BellMatrix):
        save_bell(packed, args.save_packed)
    else:
        packed.save(args.save_packed)


def _spmv_prepacked(args, coo) -> int:
    """SpMV from a saved packed artifact — skips conversion entirely, the
    amortization workflow (reference analogue: VHCC's binary matrix cache
    behind -b, MatrixDataConverter.cpp:14-89)."""
    import jax.numpy as jnp
    import numpy as np

    from cvr_tpu.bench.harness import time_fn_iterated
    from cvr_tpu.formats.sell import SellMatrix
    from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

    from cvr_tpu.formats.bell import load_bell
    from cvr_tpu.formats.dia import DiaMatrix
    from cvr_tpu.ops.spmv import spmv_fn_of

    # sniff the artifact kind from its keys
    z = np.load(args.load_packed)
    if "bell_meta" in z.files:
        packed = load_bell(args.load_packed)
    elif "bands" in z.files:
        packed = DiaMatrix.load(args.load_packed)
    else:
        packed = SellMatrix.load(args.load_packed)
    if packed.shape != coo.shape:
        print("packed artifact shape mismatch")
        return 1
    sd, kernel = spmv_fn_of(packed)
    x = np.ones(coo.shape[1], dtype=np.float32)
    t = time_fn_iterated(kernel, sd, jnp.asarray(x), iters=args.iters)
    print(
        f"[file: {args.matrix}] [packed: {args.load_packed}] "
        f"Pre-processing Time: 0.000 ms (loaded artifact)"
    )
    print(
        f"[file: {args.matrix}] SpMV Execution Time: {t * 1e3:.6f} ms"
    )
    print(
        f"[file: {args.matrix}] Throughput: "
        f"{2 * coo.nnz / t / 1e9:.3f} GFlops (2*nnz)"
    )
    if not args.no_verify:
        import jax

        csr = coo.to_csr()
        y = np.asarray(jax.jit(kernel)(sd, jnp.asarray(x)))
        ok, nbad, mx = verify(
            y,
            spmv_golden_numpy(csr, x),
            rtol=1e-6,
            row_scale=spmv_row_scale(csr, x),
        )
        print(
            f"[file: {args.matrix}] Verification: "
            + ("PASS" if ok else f"FAIL ({nbad} rows)")
        )
    return 0


def _spmm(args, coo) -> int:
    from cvr_tpu.bench.harness import time_fn_iterated
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.bell import bell_pack
    from cvr_tpu.formats.bsr import BsrInfeasible, bsr_pack
    from cvr_tpu.formats.dia import dia_pack
    from cvr_tpu.formats.sell import DEFAULT_C, sell_pack
    from cvr_tpu.ops.spmv import spmm_fn_of

    if args.format == "csr":
        print("error: --format csr has no SpMM path", file=sys.stderr)
        return 2
    csr = coo.to_csr()
    t0 = time.perf_counter()
    packed = None
    if args.format in ("auto", "bsr"):
        # Dense bricks win when the matrix has block locality; auto falls
        # back to the gather formats when the brick-fill gate rejects it.
        try:
            packed = bsr_pack(csr)
        except BsrInfeasible as e:
            if args.format == "bsr":
                print(f"error: {e}", file=sys.stderr)
                return 2
    if packed is None:
        packed = {
            "auto": lambda: pack_auto(csr),
            "bell": lambda: bell_pack(csr),
            "dia": lambda: dia_pack(csr),
            "sell": lambda: sell_pack(
                csr, C=args.c or DEFAULT_C, sigma=args.sigma
            ),
        }[args.format]()
    sd, kernel = spmm_fn_of(packed)
    preproc = time.perf_counter() - t0
    X = np.ones((coo.shape[1], args.rhs), dtype=np.float32)
    import jax.numpy as jnp

    Xd = jnp.asarray(X)
    t = time_fn_iterated(kernel, sd, Xd, iters=args.iters)
    gflops = 2.0 * csr.nnz * args.rhs / t / 1e9
    print(
        f"[file: {args.matrix}] [rhs: {args.rhs}] "
        f"Pre-processing Time: {preproc * 1e3:.3f} ms"
    )
    print(
        f"[file: {args.matrix}] [rhs: {args.rhs}] "
        f"SpMM Execution Time: {t * 1e3:.6f} ms"
    )
    print(
        f"[file: {args.matrix}] [rhs: {args.rhs}] "
        f"Throughput: {gflops:.3f} GFlops (2*nnz*K)"
    )
    # row-scaled verification vs the float64 golden (same contract as
    # the SpMV path; capped: the host-side f64 golden is O(nnz*K))
    if not args.no_verify and csr.nnz * args.rhs <= 2_000_000_000:
        Y = np.asarray(kernel(sd, Xd))
        A64 = csr.to_scipy().astype(np.float64)
        gold = A64 @ X.astype(np.float64)
        scale = np.abs(A64) @ np.abs(X.astype(np.float64)) + 1e-30
        maxrel = float((np.abs(Y - gold) / scale).max())
        ok = "PASS" if maxrel < 1e-6 else "FAIL"
        print(
            f"[file: {args.matrix}] Verification: {ok} "
            f"(max rel err {maxrel:.2e})"
        )
        if ok == "FAIL":
            return 1
    return 0


def cmd_compare(args) -> int:
    """Run every implementation on one matrix in one table — the
    run_comparison.sh analogue (reference runs 6 solutions per matrix,
    run_comparison.sh:20-45).  With --rhs K > 1 the SpMM formats (bsr /
    dia / bell / sell) are compared instead."""
    coo = _load(args.matrix, args.pattern_values)

    from cvr_tpu.formats.bell import BellInfeasible
    from cvr_tpu.formats.dia import DiaInfeasible

    # A structure gate that declines the matrix skips that format; a
    # failed verification or any other error fails the command.
    declined = (DiaInfeasible, BellInfeasible)
    failed = 0
    if args.rhs > 1:
        import argparse as _ap

        for fmt in ("bsr", "dia", "bell", "sell"):
            sub = _ap.Namespace(**{**vars(args), "format": fmt})
            try:
                failed += _spmm(sub, coo) == 1
            except declined as e:
                print(f"[{fmt}] skipped: {e}")
        return 1 if failed else 0

    from cvr_tpu.bench.harness import run_spmv_benchmark

    results = []
    for impl in ("csr", "sell", "dia", "bell"):
        try:
            r = run_spmv_benchmark(
                coo, name=args.matrix, impl=impl, iters=args.iters
            )
        except declined as e:
            print(f"[{impl}] skipped: {e}")
            continue
        r.print_report(threads_label=impl)
        results.append(r)
        failed += r.verified is False
    if results:
        best = max(results, key=lambda r: r.gflops_2nnz)
        print(
            f"Best: {best.impl} at {best.gflops_2nnz:.3f} GFlops (2*nnz)"
        )
    return 1 if failed else 0


def cmd_info(args) -> int:
    coo = _load(args.matrix, args.pattern_values)
    csr = coo.to_csr()
    lens = csr.row_lengths
    print(f"rows: {coo.shape[0]}  cols: {coo.shape[1]}  nnz: {coo.nnz}")
    print(
        f"row nnz: min {lens.min()}  mean {lens.mean():.2f}  "
        f"max {lens.max()}  empty {(lens == 0).sum()}"
    )
    from cvr_tpu.formats.sell import sell_pack

    sm = sell_pack(csr)
    print(
        f"sell-pack: C={sm.C} slices={sm.nslices} slots={sm.n_slots} "
        f"fill={sm.fill_ratio:.3f} splits={sm.n_splits} "
        f"convert={sm.convert_time * 1e3:.1f} ms"
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cvr_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("matrix", help=".mtx file (optionally .gz)")
        p.add_argument("--iters", type=int, default=100)
        p.add_argument(
            "--threads",
            type=int,
            default=None,
            help="ignored; reference-CLI compatibility",
        )
        p.add_argument(
            "--pattern-values", default="mod13", choices=["mod13", "ones"]
        )

    p = sub.add_parser("spmv", help="convert + SpMV benchmark + verify")
    common(p)
    p.add_argument(
        "--format",
        default="auto",
        choices=["auto", "bell", "bsr", "dia", "sell", "csr"],
    )
    p.add_argument("--rhs", type=int, default=1, help="K for SpMM")
    p.add_argument("--c", type=int, default=None, help="SELL lane count")
    p.add_argument("--sigma", type=int, default=0, help="sort window")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--save-packed", default=None)
    p.add_argument("--load-packed", default=None)
    p.set_defaults(fn=cmd_spmv)

    p = sub.add_parser("compare", help="all impls on one matrix")
    common(p)
    p.add_argument(
        "--rhs", type=int, default=1,
        help="K > 1 compares the SpMM formats instead",
    )
    p.add_argument("--c", type=int, default=None)
    p.add_argument("--sigma", type=int, default=0)
    p.add_argument("--no-verify", action="store_true")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("info", help="matrix + packing statistics")
    common(p)
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cvr_tpu.utils import memarena

    # warm only where first-touch is slow (lazily-backed VMs) — an
    # ordinary host would pay a pointless 1.5 GB memset sweep
    memarena.warm_if_lazy()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
