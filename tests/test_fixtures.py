"""End-to-end runs on SuiteSparse-STYLE .mtx fixtures.

The environment is offline, so tests/fixtures/ holds hand-built
miniatures written in the exact SuiteSparse formatting (banner, %-comment
block, 1-based indices, symmetric lower-triangle storage, pattern and
integer fields, gzip) instead of downloaded collection files.  Every pack
and kernel path plus the CLI runs over them and is checked against the
scipy golden — the reference validates against real downloads the same
way (run_comparison.sh:9-15 + the in-binary golden, spmv.cpp:1916-1938).
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from cvr_tpu.io.mmio import read_matrix_market
from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

FIX = Path(__file__).parent / "fixtures"

FILES = ["bus240.mtx", "snap300.mtx.gz", "lp150x220.mtx"]


def _scipy_golden(path):
    """Independent parse with scipy for the real-format files."""
    import gzip
    import io
    import scipy.io as sio

    p = FIX / path
    if p.suffix == ".gz":
        with gzip.open(p, "rb") as f:
            return sio.mmread(io.BytesIO(f.read()))
    return sio.mmread(p)


@pytest.mark.parametrize("path", FILES)
def test_reader_matches_scipy_structure(path):
    coo = read_matrix_market(FIX / path)
    ref = sp.coo_matrix(_scipy_golden(path))
    assert coo.shape == ref.shape
    # same sparsity pattern (symmetry already mirrored by both readers)
    a = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    b = set(zip(ref.row.tolist(), ref.col.tolist()))
    assert a == b
    if path != "snap300.mtx.gz":  # pattern file: values are synthetic
        ours = coo.to_scipy().todense()
        assert np.allclose(ours, ref.todense(), rtol=1e-6)


def test_bus240_is_spd_style():
    """The symmetric fixture must mirror the lower triangle."""
    coo = read_matrix_market(FIX / "bus240.mtx")
    d = np.asarray(coo.to_scipy().todense())
    assert np.allclose(d, d.T)
    assert (np.linalg.eigvalsh(d) > 0).all()  # diagonally dominant SPD


@pytest.mark.parametrize("path", FILES)
def test_all_spmv_paths_on_fixture(path):
    coo = read_matrix_market(FIX / path)
    csr = coo.to_csr()
    x = (
        np.random.default_rng(3)
        .standard_normal(coo.shape[1])
        .astype(np.float32)
    )
    gold = spmv_golden_numpy(csr, x)
    rs = spmv_row_scale(csr, x)

    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.bell import BellInfeasible, bell_pack
    from cvr_tpu.formats.dia import DiaInfeasible, dia_pack
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmv import sell_spmv_xla, spmv, to_device

    ys = {
        "sell-xla": np.asarray(
            sell_spmv_xla(to_device(sell_pack(csr)), x)
        ),
        "auto": np.asarray(spmv(pack_auto(csr), x)),
    }
    for name, pack, declined in (
        ("dia", dia_pack, DiaInfeasible),
        ("bell", bell_pack, BellInfeasible),
    ):
        try:
            ys[name] = np.asarray(spmv(pack(csr), x))
        except declined:
            pass

    for name, y in ys.items():
        ok, nbad, maxrel = verify(y, gold, rtol=1e-6, row_scale=rs)
        assert ok, (name, nbad, maxrel)


def test_spmm_paths_on_fixture():
    coo = read_matrix_market(FIX / "bus240.mtx")
    csr = coo.to_csr()
    X = (
        np.random.default_rng(5)
        .standard_normal((coo.shape[1], 7))
        .astype(np.float32)
    )
    m64 = coo.to_scipy().astype(np.float64)
    gold = m64 @ X
    scale = abs(m64) @ np.abs(X.astype(np.float64)) + 1e-30

    from cvr_tpu.formats.bsr import bsr_pack
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmm_bsr import spmm_bsr, to_device_bsr
    from cvr_tpu.ops.spmv import sell_spmm_xla, spmm, to_device

    bm = bsr_pack(csr, min_fill=0.0)
    Ys = (
        spmm_bsr(to_device_bsr(bm), X),
        spmm(bm, X),
        sell_spmm_xla(to_device(sell_pack(csr)), X),
    )
    for Y in Ys:
        assert (np.abs(np.asarray(Y) - gold) / scale).max() < 1e-6


@pytest.mark.parametrize("path", ["bus240.mtx", "snap300.mtx.gz"])
def test_cli_on_fixture(path, capsys):
    from cvr_tpu.cli import main

    rc = main(["spmv", str(FIX / path), "--iters", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Pre-processing Time" in out
    assert "SpMV Execution Time" in out
    assert "Throughput" in out
    assert "Verification: PASS" in out


def test_cli_compare_on_fixture(capsys):
    from cvr_tpu.cli import main

    rc = main(["compare", str(FIX / "bus240.mtx"), "--iters", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    # every SpMV impl appears in one table (a declining gate says so)
    for impl in ("csr", "sell", "dia", "bell"):
        assert f"[threads: {impl}]" in out or f"[{impl}] skipped" in out
    assert "Best:" in out


def test_skew_symmetric_fixture():
    """skew-symmetric storage: the reader must mirror with negation."""
    coo = read_matrix_market(FIX / "skew180.mtx")
    d = np.asarray(coo.to_scipy().todense())
    assert np.allclose(d, -d.T)
    assert np.allclose(np.diag(d), 0)
    ref = sp.coo_matrix(_scipy_golden("skew180.mtx"))
    assert np.allclose(d, ref.todense(), rtol=1e-6)
    # end-to-end through pack_auto + spmv
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.ops.spmv import spmv

    csr = coo.to_csr()
    x = np.random.default_rng(0).standard_normal(180).astype(np.float32)
    y = np.asarray(spmv(pack_auto(csr), x))
    ok, nbad, mx = verify(
        y, spmv_golden_numpy(csr, x),
        rtol=1e-6, row_scale=spmv_row_scale(csr, x),
    )
    assert ok, (nbad, mx)
