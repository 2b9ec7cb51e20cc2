"""Multi-threaded native converter determinism.

The native converter's OpenMP regions (parallel parse, counting sort,
SELL plan/fill, BSR and DIA passes — native/cvr_native.cpp) must not
depend on the thread count.  The reference's converter is parallel by
design (spmv.cpp:577); these tests run OMP_NUM_THREADS = 1 / 2 / 8 in subprocesses (libgomp reads
the env at startup) and assert BIT-IDENTICAL pack artifacts: every
parallel region must partition its writes disjointly and use only
order-independent reductions.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import hashlib
import os
import tempfile
import numpy as np
from cvr_tpu.bench.synthetic import rmat_matrix
from cvr_tpu.io.mmio import write_matrix_market
import cvr_tpu

coo0 = rmat_matrix(scale=13, edge_factor=8, seed=3, cache=False)
path = os.path.join(tempfile.mkdtemp(), "omp_det.mtx")
write_matrix_market(path, coo0)
coo = cvr_tpu.read_matrix_market(path)  # native parser
h = hashlib.sha256()
h.update(np.ascontiguousarray(coo.rows).tobytes())
h.update(np.ascontiguousarray(coo.cols).tobytes())
h.update(np.ascontiguousarray(coo.vals).tobytes())

sm = cvr_tpu.sell_pack(coo.to_csr(sort_cols=False), C=128)  # native pack
for a in (sm.vals_plane, sm.cols_plane, sm.slice_offsets, sm.perm,
          sm.seg_offset, sm.lane_lengths):
    h.update(np.ascontiguousarray(a).tobytes())

from cvr_tpu.bench.synthetic import banded_matrix

band = banded_matrix(n=5000, bandwidth=7, seed=4).to_csr()
h.update(np.ascontiguousarray(cvr_tpu.dia_pack(band).bands).tobytes())
h.update(np.ascontiguousarray(cvr_tpu.bsr_pack(band).vals).tobytes())

from cvr_tpu.formats.bell import BellInfeasible, bell_pack
from cvr_tpu.bench.synthetic import road_usa_like

bm = bell_pack(road_usa_like(n=1 << 13, deg=2.5, reach=48, seed=5).to_csr())
h.update(np.ascontiguousarray(bm.li).tobytes())
h.update(np.ascontiguousarray(bm.vals).tobytes())
print("HASH", h.hexdigest())
"""


def _run(threads: int) -> str:
    env = dict(
        os.environ,
        OMP_NUM_THREADS=str(threads),
        JAX_PLATFORMS="cpu",
    )
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=420,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        if line.startswith("HASH "):
            return line.split()[1]
    raise AssertionError(f"no hash in output: {out.stdout[-500:]}")


def test_converter_thread_determinism():
    hashes = {t: _run(t) for t in (1, 2, 8)}
    assert len(set(hashes.values())) == 1, hashes


def test_library_reports_its_threads():
    # the threads every report names beside a pack time
    out = subprocess.run(
        [sys.executable, "-c",
         "from cvr_tpu import _native; print('THREADS', _native.omp_threads())"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="3", JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "THREADS 3" in out.stdout, out.stdout[-500:]
