#!/usr/bin/env python
"""Smoke run of the main path on an NVIDIA GPU, at real sizes.

  python chip_smoke.py               # every phase, one card
  python chip_smoke.py --four-cards  # row-sharded SELL SpMV on 4 cards
                                     # against the same matrix on one card
  python chip_smoke.py --rehearse    # tiny sizes on the CPU backend

Phases: 1 device, 2 compile check of every kernel at real widths, 3
MatrixMarket ingest, 4 main path: run_spmv_benchmark(impl="auto") on
web-Google-like, soc-LiveJournal-full-like, banded-2M and road-usa-like,
then the CLI (``cvr_tpu.cli.main``: spmv and compare, SpMV and SpMM) on
the ingested .mtx files and ``bench.py``'s main, 5 PageRank and CG, 6 the
tests marked ``gpu``.  Every SpMV/SpMM result is
checked against the float64 golden at rtol 1e-6 with the row-scaled
bound.  One process drives the card(s); the last line of stdout is one
JSON object, {"ok": true, "device": {...}} on success.  Without a GPU
(and without --rehearse) it fails, as any failed phase does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--rehearse", action="store_true")
    return ap.parse_args(argv)


class Smoke:
    def __init__(self, args):
        import jax

        from cvr_tpu import platform

        self.args = args
        self.jax = jax
        self.info = platform.device_info()
        self.smi = platform.nvidia_smi_line() or "no nvidia-smi"
        self.tag = f"[{self.info.kind} | {self.smi}]"
        self.tiny = args.rehearse
        self._mats = {}
        self.workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
        self.mtx = {}  # matrix name -> .mtx path written by phase 3

    def say(self, phase, msg):
        print(f"[{phase}] {self.tag} {msg}", flush=True)

    # -- matrices, made once per process ---------------------------------
    def matrix(self, name):
        from cvr_tpu.bench import synthetic as syn

        if name not in self._mats:
            t0 = time.perf_counter()
            make = {
                "web-Google-like": lambda: (
                    syn.rmat_matrix(scale=12, edge_factor=6, seed=42, cache=False)
                    if self.tiny else syn.web_google_like()
                ),
                "soc-LiveJournal-full-like": lambda: (
                    syn.rmat_matrix(scale=13, edge_factor=9, seed=11, cache=False)
                    if self.tiny else syn.soc_livejournal_full()
                ),
                "banded-2M": lambda: syn.banded_matrix(
                    (1 << 13) if self.tiny else (1 << 21), bandwidth=27
                ),
                "banded-1M": lambda: syn.banded_matrix(
                    (1 << 12) if self.tiny else (1 << 20), bandwidth=27, seed=1
                ),
                "banded-256K": lambda: syn.banded_matrix(
                    (1 << 12) if self.tiny else (1 << 18), bandwidth=27, seed=2
                ),
                "road-usa-like": lambda: syn.road_usa_like(
                    n=(1 << 14) if self.tiny else (1 << 23)
                ),
            }[name]
            coo = make()
            self._mats[name] = (coo, coo.to_csr())
            self.say(
                "data",
                f"{name}: {coo.shape[0]} x {coo.shape[1]}, {coo.nnz} nnz, "
                f"made in {time.perf_counter() - t0:.1f} s",
            )
        return self._mats[name]

    # -- checks ----------------------------------------------------------
    def check_spmv(self, phase, what, csr, y, x):
        from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

        ok, nbad, err = verify(
            y, spmv_golden_numpy(csr, x), rtol=1e-6,
            row_scale=spmv_row_scale(csr, x),
        )
        self.say(phase, f"{what}: verify {'PASS' if ok else 'FAIL'} "
                 f"({nbad} rows over bound, max scaled err {err:.2e})")
        if not ok:
            raise AssertionError(f"{what} failed verification")

    def check_spmm(self, phase, what, csr, Y, X):
        import numpy as np

        m64 = csr.to_scipy().astype(np.float64)
        X64 = X.astype(np.float64)
        err = np.abs(np.asarray(Y, np.float64) - m64 @ X64)
        bound = 1e-6 * (1.0 + abs(m64) @ np.abs(X64))
        ok = bool((err <= bound).all())
        self.say(phase, f"{what}: verify {'PASS' if ok else 'FAIL'} "
                 f"({int((err > bound).sum())} entries over bound, max scaled "
                 f"err {float((err / (bound / 1e-6)).max()):.2e})")
        if not ok:
            raise AssertionError(f"{what} failed verification")

    # -- phases ----------------------------------------------------------
    def phase_device(self):
        from cvr_tpu import _native
        from cvr_tpu.bench.harness import converter_label

        devs = self.jax.devices()
        self.say("1 device", f"platform {self.info.platform}, kind "
                 f"{self.info.kind}, count {self.info.count}: {devs}")
        native = _native.available()
        cxx = os.environ.get("CXX", "g++")
        try:
            cxx_version = subprocess.run(
                [cxx, "--version"], capture_output=True, text=True, timeout=30
            ).stdout.partition("\n")[0]
        except OSError as e:
            cxx_version = repr(e)
        self.say("1 device", f"native library loaded: {native}; pack times "
                 f"below are from: {converter_label(_native.omp_threads())}; "
                 f"compiler {cxx}: {cxx_version}")
        if not native:
            raise RuntimeError(
                f"the native library did not build or load: {_native.build_error}")

    def phase_compile(self):
        import numpy as np

        from cvr_tpu.formats.bell import bell_pack
        from cvr_tpu.formats.bsr import bsr_pack
        from cvr_tpu.formats.dia import dia_pack
        from cvr_tpu.formats.sell import sell_pack
        from cvr_tpu.ops.spmv import spmm_fn_of, spmv_fn_of

        jnp = self.jax.numpy
        rng = np.random.default_rng(0)
        cases = [
            ("SELL SpMV", "web-Google-like", sell_pack, 0),
            ("SELL SpMM K=32", "web-Google-like", sell_pack, 32),
            ("DIA SpMV", "banded-2M", dia_pack, 0),
            ("DIA SpMM K=32", "banded-2M", dia_pack, 32),
            ("BELL SpMV", "road-usa-like", bell_pack, 0),
            ("BSR SpMM K=128", "banded-1M", bsr_pack, 128),
        ]
        for what, name, pack, K in cases:
            _, csr = self.matrix(name)
            packed = pack(csr)
            sd, fn = (spmm_fn_of if K else spmv_fn_of)(packed)
            shape = (csr.shape[1], K) if K else (csr.shape[1],)
            x = rng.standard_normal(shape).astype(np.float32)
            t0 = time.perf_counter()
            compiled = self.jax.jit(fn).lower(sd, jnp.asarray(x)).compile()
            t_c = time.perf_counter() - t0
            fusions = sum(
                " fusion(" in line
                for line in compiled.as_text().split("ENTRY", 1)[-1].splitlines()
            )
            self.say("2 compile", f"{what} on {name}: compiled in {t_c:.2f} s, "
                     f"{fusions} fusion(s) in the entry computation, "
                     f"{compiled.memory_analysis()}")
            y = np.asarray(compiled(sd, jnp.asarray(x)))
            if K:
                self.check_spmm("2 compile", f"{what} on {name}", csr, y, x)
            else:
                self.check_spmv("2 compile", f"{what} on {name}", csr, y, x)

    def phase_ingest(self):
        import numpy as np

        import cvr_tpu

        for name in ("web-Google-like", "banded-256K"):
            coo, csr = self.matrix(name)
            path = os.path.join(self.workdir.name, f"{name}.mtx")
            t0 = time.perf_counter()
            cvr_tpu.write_matrix_market(path, coo)
            t_w = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = cvr_tpu.read_matrix_market(path).to_csr()
            t_r = time.perf_counter() - t0
            same = (
                back.shape == csr.shape
                and np.array_equal(back.rowptr, csr.rowptr)
                and np.array_equal(back.cols, csr.cols)
                and np.allclose(back.vals, csr.vals, rtol=1e-6)
            )
            self.say("3 ingest", f"{name} .mtx: written in {t_w:.2f} s, "
                     f"read back in {t_r:.2f} s, identical: {same}")
            if not same:
                raise AssertionError(f"MatrixMarket round trip changed {name}")
            self.mtx[name] = path

    def _copy_bandwidth(self):
        """Bytes/s of a large elementwise copy (read + write) on the card."""
        jnp = self.jax.numpy
        n = (1 << 20) if self.tiny else (1 << 28)  # 1 GiB of f32
        a = jnp.zeros(n, jnp.float32)
        f = self.jax.jit(lambda v: v + 1.0)
        self.jax.block_until_ready(f(a))
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            a = f(a)
        self.jax.block_until_ready(a)
        return 2 * 4 * n * reps / (time.perf_counter() - t0)

    def phase_main(self):
        from cvr_tpu.bench.harness import run_spmv_benchmark

        copy_bw = self._copy_bandwidth()
        self.say("4 main", f"device copy: {copy_bw / 1e9:.1f} GB/s (read+write)")
        for name in ("web-Google-like", "soc-LiveJournal-full-like",
                     "banded-2M", "road-usa-like"):
            coo, _ = self.matrix(name)
            r = run_spmv_benchmark(coo, name=name, impl="auto", iters=50)
            r.print_report()
            bw = r.bytes_per_spmv / r.spmv_s
            roof = ("not measured" if r.roofline_frac is None
                    else f"{100 * r.roofline_frac:.1f}%")
            self.say("4 main", f"{name} [{r.impl}]: pack {r.preproc_s * 1e3:.1f} ms, "
                     f"SpMV {r.spmv_s * 1e6:.2f} us, {r.gflops_2nnz:.2f} GFLOPS, "
                     f"{r.gnnz_per_s * 1e9:.4g} nnz/s, {r.bytes_per_spmv / 1e6:.1f} MB "
                     f"moved ({bw / 1e9:.1f} GB/s): {roof} of published HBM peak, "
                     f"{100 * bw / copy_bw:.1f}% of device copy, verification "
                     f"{'PASS' if r.verified else 'FAIL'} (max err {r.max_rel_err:.2e})")
            if not r.verified:
                raise AssertionError(f"{name} failed verification")

    def phase_cli(self):
        """The CLI through its main(), in this process, on phase 3's files."""
        from cvr_tpu import cli

        web, band = self.mtx["web-Google-like"], self.mtx["banded-256K"]
        for argv in (
            ["spmv", web, "--iters", "50"],
            ["compare", web, "--iters", "50"],
            ["spmv", band, "--format", "bsr", "--rhs", "128", "--iters", "20"],
            ["compare", band, "--rhs", "32", "--iters", "20"],
        ):
            shown = " ".join(os.path.basename(a) for a in argv)
            t0 = time.perf_counter()
            rc = cli.main(argv)
            self.say("4 cli", f"python -m cvr_tpu.cli {shown}: exit {rc} "
                     f"in {time.perf_counter() - t0:.1f} s")
            if rc != 0:
                raise AssertionError(f"cvr_tpu.cli {shown} exited {rc}")

    def phase_bench(self):
        """bench.py's main, in this process; its JSON line names the card."""
        from cvr_tpu import platform

        import bench

        argv = ["--quick", "--iters", "5"] if self.tiny else []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(argv)
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            print(line)
        line = json.loads(lines[-1])
        self.say("4 bench", f"python bench.py {' '.join(argv)}: exit {rc}, "
                 f"{line['value']} {line['unit']}, device {line['device']}, "
                 f"power limit {line['power_limit']}")
        if rc != 0:
            raise AssertionError(f"bench.py exited {rc}")
        if (line["device"] != self.info.as_dict()
                or line["power_limit"] != platform.power_limit()):
            raise AssertionError("bench.py's JSON line names another device")

    def phase_models(self):
        import numpy as np
        import scipy.sparse as sp

        from cvr_tpu.formats import pack_auto
        from cvr_tpu.formats.coo import COOMatrix
        from cvr_tpu.models.pagerank import pagerank
        from cvr_tpu.models.solvers import conjugate_gradient
        from cvr_tpu.ops.spmv import spmv_fn_of
        from cvr_tpu.ops.spmv_ref import spmv_golden_numpy

        jnp = self.jax.numpy
        # PageRank: 20 power iterations on the web-Google-like graph.
        coo, _ = self.matrix("web-Google-like")
        n = coo.shape[0]
        ones = np.ones(coo.nnz, np.float32)
        adj_t = COOMatrix(coo.cols, coo.rows, ones, (n, n)).to_csr()
        deg = np.bincount(coo.rows, minlength=n).astype(np.float32)
        sd, fn = spmv_fn_of(pack_auto(adj_t))
        run = self.jax.jit(lambda a, d: pagerank(
            lambda p: fn(a, p), n, tol=0.0, max_iters=20, out_degree=d))
        self.jax.block_until_ready(run(sd, jnp.asarray(deg)))
        t0 = time.perf_counter()
        p, iters, _ = run(sd, jnp.asarray(deg))
        p = np.asarray(p)
        t_pr = time.perf_counter() - t0
        A_t = sp.csr_matrix((adj_t.vals.astype(np.float64), adj_t.cols, adj_t.rowptr), shape=(n, n))
        ref = np.full(n, 1.0 / n)
        for _ in range(20):
            contrib = np.where(deg > 0, ref / np.maximum(deg, 1), 0.0)
            ref = 0.15 / n + 0.85 * (A_t @ contrib + ref[deg == 0].sum() / n)
            ref /= np.abs(ref).sum()
        err = float(np.abs(p - ref).sum())
        self.say("5 models", f"PageRank web-Google-like: {int(iters)} iterations in "
                 f"{t_pr * 1e3:.1f} ms, L1 distance to the float64 numpy power "
                 f"method {err:.2e}")
        if not err < 1e-4:
            raise AssertionError("PageRank disagrees with the numpy power method")

        # CG: banded SPD system (symmetrised band + dominant diagonal).
        band = self.matrix("banded-2M")[0]
        m = band.to_scipy().tocsr()
        m = (m + m.T) * 0.5
        m = m + sp.diags(np.asarray(abs(m).sum(axis=1)).ravel() + 1.0)
        csr = COOMatrix.from_scipy(m.astype(np.float32)).to_csr()
        sd, fn = spmv_fn_of(pack_auto(csr))
        b = np.random.default_rng(1).standard_normal(csr.shape[0]).astype(np.float32)
        solve = self.jax.jit(lambda a, rhs: conjugate_gradient(
            lambda v: fn(a, v), rhs, tol=1e-6, max_iters=1000))
        self.jax.block_until_ready(solve(sd, jnp.asarray(b)))
        t0 = time.perf_counter()
        x, iters, res = solve(sd, jnp.asarray(b))
        x = np.asarray(x)
        t_cg = time.perf_counter() - t0
        true_res = float(np.linalg.norm(b - spmv_golden_numpy(csr, x)) / np.linalg.norm(b))
        self.say("5 models", f"CG banded SPD ({type(sd).__name__}, {csr.nnz} nnz): "
                 f"{int(iters)} iterations in {t_cg * 1e3:.1f} ms, recursive "
                 f"residual {float(res):.2e}, float64 true residual {true_res:.2e}")
        if not (float(res) <= 1e-6 and true_res < 1e-5):
            raise AssertionError("CG did not reach a 1e-6 relative residual")

    def phase_gpu_tests(self):
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-rs",
                          os.path.join(ROOT, "tests")])
        self.say("6 gpu tests", f"pytest -m gpu exit code {rc}")
        if rc != 0:
            raise AssertionError(f"gpu-marked tests failed (exit {rc})")

    def phase_four_cards(self):
        import dataclasses

        import numpy as np

        from cvr_tpu.bench.harness import time_fn_iterated
        from cvr_tpu.formats.sell import sell_pack
        from cvr_tpu.ops.spmv import sell_spmv_xla, to_device
        from cvr_tpu.parallel.dist import dist_sell_pack, dist_spmv, make_mesh

        jnp = self.jax.numpy
        if self.info.count < 4:
            raise RuntimeError(f"--four-cards needs 4 devices, found {self.info.count}")
        name = "soc-LiveJournal-full-like"
        _, csr = self.matrix(name)
        x = np.random.default_rng(2).standard_normal(csr.shape[1]).astype(np.float32)
        row_abs = np.bincount(csr.row_ids(), weights=np.abs(csr.vals.astype(np.float64)),
                              minlength=csr.shape[0])
        scale = 1.0 / float(row_abs.max())

        t0 = time.perf_counter()
        dm = dist_sell_pack(csr, make_mesh(4))
        t_pack = time.perf_counter() - t0

        def step(arrs, v):
            planes, unpad = arrs
            return dist_spmv(dataclasses.replace(dm, planes=planes, unpad_index=unpad),
                             v, x_sharded=True)

        arrs = (dm.planes, dm.unpad_index)
        y = np.asarray(self.jax.jit(step)(arrs, jnp.asarray(x)))
        self.check_spmv("7 four cards", f"{name} row-sharded over 4 cards", csr, y, x)
        t4 = time_fn_iterated(step, arrs, jnp.asarray(x), iters=50, scale=scale)
        for d in self.jax.devices()[:4]:
            stats = d.memory_stats() or {}
            self.say("7 four cards", f"{d}: peak_bytes_in_use "
                     f"{stats.get('peak_bytes_in_use', 'n/a')}")
        self.say("7 four cards", f"{name}: pack {t_pack:.2f} s, balance "
                 f"{dm.balance['imbalance']:.3f}, SpMV on 4 cards {t4 * 1e6:.2f} us "
                 f"({2 * csr.nnz / t4 / 1e9:.2f} GFLOPS)")

        dev0 = self.jax.devices()[0]
        sd = to_device(sell_pack(csr), dev0)
        x0 = self.jax.device_put(x, dev0)
        self.check_spmv("7 four cards", f"{name} on one card", csr,
                        np.asarray(self.jax.jit(sell_spmv_xla)(sd, x0)), x)
        t1 = time_fn_iterated(sell_spmv_xla, sd, x0, iters=50, scale=scale)
        self.say("7 four cards", f"{name}: SpMV on one card {t1 * 1e6:.2f} us "
                 f"({2 * csr.nnz / t1 / 1e9:.2f} GFLOPS); 4-card speedup {t1 / t4:.2f}x")

    def run(self):
        try:
            self._run()
        finally:
            self.workdir.cleanup()

    def _run(self):
        if self.info.platform != "gpu" and not self.args.rehearse:
            raise RuntimeError(
                f"no GPU: JAX found {self.info.platform} ({self.info.kind})")
        if self.args.rehearse:
            self.say("rehearse", "REHEARSAL on the CPU backend at tiny sizes; "
                     "no number here is a device measurement")
        self.phase_device()
        if self.args.four_cards:
            self.phase_four_cards()
            return
        self.phase_compile()
        self.phase_ingest()
        self.phase_main()
        self.phase_cli()
        self.phase_bench()
        self.phase_models()
        self.phase_gpu_tests()


def main(argv=None) -> int:
    args = _parse(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                       + " --xla_force_host_platform_device_count=4")
    sys.path.insert(0, ROOT)
    try:
        from cvr_tpu.utils.compilecache import enable

        enable()
        smoke = Smoke(args)
        smoke.run()
    except Exception as e:  # report every failure on the last line
        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}))
        return 1
    info = smoke.info.as_dict()
    if args.rehearse:
        info["platform"] = "rehearsal-" + info["platform"]
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
