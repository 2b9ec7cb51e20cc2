"""Benchmark-harness tests (CPU): metric math, report contract, synthetic
generators, results.csv appender."""

import json

import numpy as np
import pytest

from cvr_tpu.bench.harness import BenchResult, run_spmv_benchmark
from cvr_tpu.bench.synthetic import banded_matrix, rmat_matrix
from cvr_tpu.utils.report import append_result, append_jsonl


class TestSynthetic:
    def test_rmat_deterministic(self):
        a = rmat_matrix(scale=8, edge_factor=4, seed=5, cache=False)
        b = rmat_matrix(scale=8, edge_factor=4, seed=5, cache=False)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.vals, b.vals)

    def test_rmat_power_law(self):
        coo = rmat_matrix(scale=12, edge_factor=8, seed=1, cache=False)
        lens = coo.to_csr().row_lengths
        # Heavy tail: max row far above mean.
        assert lens.max() > 8 * max(lens.mean(), 1)

    def test_banded(self):
        coo = banded_matrix(100, bandwidth=5)
        lens = coo.to_csr().row_lengths
        assert lens.max() == 5 and lens.min() >= 3


class TestHarness:
    def test_end_to_end_cpu(self):
        coo = rmat_matrix(scale=9, edge_factor=6, seed=2, cache=False)
        r = run_spmv_benchmark(
            coo, name="t", impl="sell", iters=3
        )
        assert r.verified is True
        assert r.gflops_2nnz > 0
        assert r.nnz == coo.nnz
        assert 2 * r.gnnz_per_s == pytest.approx(r.gflops_2nnz)

    def test_pack_repeats_reports_first_run(self):
        # pack_repeats > 1: preproc_s is the min over repeats (the
        # algorithm's time); the first run is kept alongside so neither
        # hides.
        coo = rmat_matrix(scale=9, edge_factor=6, seed=2, cache=False)
        r = run_spmv_benchmark(
            coo, name="t", impl="sell", iters=3, pack_repeats=2,
        )
        assert r.preproc_first_s is not None
        assert r.preproc_first_s >= r.preproc_s
        r1 = run_spmv_benchmark(
            coo, name="t", impl="sell", iters=3
        )
        assert r1.preproc_first_s is None

    def test_rejects_rectangular(self):
        from cvr_tpu.formats.coo import COOMatrix

        # rectangular matrices are benchmarkable (the timing loop
        # slices/pads the carry around A; see test_benchmark_rectangular)
        coo = COOMatrix(
            rows=np.array([0], dtype=np.int32),
            cols=np.array([1], dtype=np.int32),
            vals=np.array([1.0], dtype=np.float32),
            shape=(2, 3),
        )
        r = run_spmv_benchmark(coo, iters=1)
        assert r.verified

    def test_report_grep_contract(self, capsys):
        r = BenchResult(
            name="m.mtx",
            impl="sell",
            nnz=100,
            padded_nnz=128,
            preproc_s=0.5,
            spmv_s=0.001,
            iters=10,
            gflops_2nnz=0.2,
            gnnz_per_s=0.1,
            roofline_frac=0.5,
            amortize_iters=500.0,
            verified=True,
            max_rel_err=1e-7,
        )
        r.print_report()
        out = capsys.readouterr().out
        # The three greppable lines the reference scripts rely on
        # (README.md:47-49).
        assert "Pre-processing Time" in out
        assert "SpMV Execution Time" in out
        assert "Throughput" in out
        assert "Verification: PASS" in out


class TestReport:
    def test_csv_and_jsonl(self, tmp_path):
        r = BenchResult(
            name="a",
            impl="csr",
            nnz=1,
            padded_nnz=1,
            preproc_s=0.1,
            spmv_s=0.01,
            iters=2,
            gflops_2nnz=1.0,
            gnnz_per_s=0.5,
            roofline_frac=0.1,
            amortize_iters=10.0,
        )
        csvp = tmp_path / "results.csv"
        append_result(r, csvp)
        append_result(r, csvp)
        lines = csvp.read_text().strip().splitlines()
        assert len(lines) == 3 and lines[0].startswith("name,")
        jp = tmp_path / "results.jsonl"
        append_jsonl(r, jp)
        row = json.loads(jp.read_text())
        assert row["impl"] == "csr"


def test_benchmark_rectangular():
    """The harness benchmarks non-square matrices (the reference accepts
    any .mtx): the timing loop slices/pads the carry around A."""
    from conftest import make_random_coo
    from cvr_tpu.bench.harness import run_spmv_benchmark

    coo = make_random_coo(900, 500, density=0.02, seed=8)
    r = run_spmv_benchmark(coo, name="rect", impl="sell", iters=4)
    assert r.verified
    assert r.spmv_s > 0
