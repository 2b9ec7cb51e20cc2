"""Print the comm-volume / weak-scaling table from benchmark JSON lines.

Usage: python scripts/comm_model.py RESULTS.jsonl

RESULTS.jsonl holds BenchResult JSON lines (cvr_tpu.utils.report
.append_jsonl, or bench.py's stderr).  Emits, per matrix (latest row per
name with shape info): HBM bytes streamed per shard per iteration, bytes
gathered per shard over NVLink, the modeled comm time, and the projected
weak-scaling efficiency at D = 4 / 8 for the blocking all-gather path vs
an ideally overlapped one, plus the largest D that keeps E >= 70%
(BASELINE.md target).  See cvr_tpu/parallel/comm_model.py for the model.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cvr_tpu.parallel.comm_model import comm_table, knee_devices, weak_scaling


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    args = ap.parse_args()

    latest: dict[str, dict] = {}
    with open(args.jsonl) as f:
        for line in f:
            r = json.loads(line)
            if r.get("ncols"):
                latest[r["name"]] = r
    rows = list(latest.values())
    if not rows:
        print(f"no rows with shape info in {args.jsonl}", file=sys.stderr)
        return 1

    hdr = (
        f"{'matrix':<26} {'HBM MB/it':>10} {'NVLink MB/it@4':>15} "
        f"{'t_comp ms':>10} {'t_comm ms@4':>12} "
        f"{'E4 blk/ovl':>12} {'E8 blk/ovl':>12} {'D@70% blk/ovl':>14}"
    )
    print(hdr)
    print("-" * len(hdr))
    for cr in comm_table(rows, D=4):
        ncols = int(latest[cr.name]["ncols"])
        e8 = weak_scaling(cr.t_comp_s, ncols, 8)
        kb, ko = knee_devices(cr.t_comp_s, ncols)
        print(
            f"{cr.name:<26} {cr.stream_bytes / 1e6:>10.1f} "
            f"{cr.gather_bytes / 1e6:>15.2f} {cr.t_comp_s * 1e3:>10.3f} "
            f"{cr.t_comm_s * 1e3:>12.4f} "
            f"{cr.eff_blocking:>5.2f}/{cr.eff_overlap:<5.2f} "
            f"{e8[1]:>5.2f}/{e8[2]:<5.2f} {kb:>6d}/{ko:<6d}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
