#!/usr/bin/env python
"""SELL slice width C for the SELL SpMV, on the GPU.

For web-Google-like and soc-LiveJournal-full-like and each C in
{32, 128, 1024}: pack once, check the SpMV against the float64 golden,
then time it twice with the harness's slope timer (whole SpMV, combine
included).  This is the sweep that set formats/sell.py DEFAULT_C.  One
JSON line per timing is printed and appended to
results/sell_sweep.jsonl (--out to change).

  python scripts/sell_sweep.py            # the sweep (needs a GPU)
  python scripts/sell_sweep.py --quick    # compile + verify at small size
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="results/sell_sweep.jsonl")
    args = ap.parse_args()

    import jax
    import numpy as np

    from cvr_tpu import platform
    from cvr_tpu.bench.harness import time_fn_iterated
    from cvr_tpu.bench.synthetic import rmat_matrix, soc_livejournal_full, web_google_like
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmv import sell_spmv_xla, to_device
    from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

    info = platform.device_info()
    if info.platform != "gpu" and not args.quick:
        print(f"needs a GPU, found {info.platform}", file=sys.stderr)
        return 2
    print(f"device: {info.as_dict()} | {platform.nvidia_smi_line()}", flush=True)

    if args.quick:
        mats = {"rmat16": lambda: rmat_matrix(scale=16, edge_factor=8, seed=3, cache=False)}
    else:
        mats = {
            "web-Google-like": web_google_like,
            "soc-LiveJournal-full-like": soc_livejournal_full,
        }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ok_all = True
    with open(args.out, "a") as out:
        for name, make in mats.items():
            t0 = time.perf_counter()
            csr = make().to_csr()
            x = np.random.default_rng(0).standard_normal(csr.shape[1]).astype(np.float32)
            gold = spmv_golden_numpy(csr, x)
            rs = spmv_row_scale(csr, x)
            row_abs = np.bincount(csr.row_ids(), weights=np.abs(csr.vals.astype(np.float64)), minlength=csr.shape[0])
            scale = 1.0 / float(row_abs.max())
            print(f"{name}: {csr.shape[0]} rows, {csr.nnz} nnz, made in {time.perf_counter() - t0:.1f} s", flush=True)
            for C in (32, 128, 1024):
                sm = sell_pack(csr, C=C)
                sd = to_device(sm)
                xd = jax.numpy.asarray(x)
                t0 = time.perf_counter()
                compiled = jax.jit(sell_spmv_xla).lower(sd, xd).compile()
                t_compile = time.perf_counter() - t0
                y = np.asarray(compiled(sd, xd))
                ok, nbad, err = verify(y, gold, rtol=1e-6, row_scale=rs)
                ok_all &= ok
                print(
                    f"  C={C}: compile {t_compile:.2f} s, verify "
                    f"{'PASS' if ok else 'FAIL'} ({nbad} rows, max err {err:.2e}), "
                    f"fill {sm.fill_ratio:.3f}, splits {sm.n_splits}; "
                    f"{compiled.memory_analysis()}",
                    flush=True,
                )
                if args.quick:
                    continue
                for turn in range(2):
                    t = time_fn_iterated(sell_spmv_xla, sd, xd, iters=50, scale=scale)
                    row = {
                        "matrix": name, "nnz": csr.nnz, "C": C, "turn": turn,
                        "spmv_s": t, "gflops": 2 * csr.nnz / t / 1e9,
                        "device": info.as_dict(), "nvidia_smi": platform.nvidia_smi_line(),
                    }
                    print(json.dumps(row), flush=True)
                    out.write(json.dumps(row) + "\n")
                del sd, sm
    print("ALL VERIFIED" if ok_all else "VERIFICATION FAILED")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
