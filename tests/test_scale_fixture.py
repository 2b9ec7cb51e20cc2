"""Scale fixture: a ~1.5M-nnz SNAP-like graph with >=50K-nnz hub rows.

The reference validates on 58 real SuiteSparse downloads
(run_comparison.sh:9-15); this offline stand-in exercises the reader,
every pack gate, the hub-row split machinery and the XLA compute path
at a scale where real degree distributions (not the 240-row minis in
tests/fixtures/) can break split_len assumptions.
"""

import gzip
import shutil

import numpy as np
import pytest

from cvr_tpu.formats.coo import COOMatrix


N_ROWS = 200_000
HUBS = (0, 7, 51)  # rows given >= 50K nnz each
HUB_DEG = 70_000


@pytest.fixture(scope="module")
def snap_large(tmp_path_factory):
    """Deterministic SNAP-like .mtx.gz written + parsed once."""
    rng = np.random.default_rng(20260817)
    # Zipf-ish out-degrees plus three celebrity hub rows
    deg = np.minimum(
        (1.8 / rng.random(N_ROWS) ** 0.8).astype(np.int64), 5_000
    )
    rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), deg)
    hub_rows = np.repeat(
        np.asarray(HUBS, dtype=np.int64), HUB_DEG
    )
    rows = np.concatenate([rows, hub_rows])
    nnz = rows.shape[0]
    # power-law in-degrees: quadratic transform concentrates columns;
    # hub rows draw uniformly so deduplication keeps their >=50K degree
    cols = (N_ROWS * rng.random(nnz) ** 2.2).astype(np.int64)
    nh = len(HUBS) * HUB_DEG
    cols[-nh:] = rng.integers(0, N_ROWS, nh)
    vals = rng.standard_normal(nnz).astype(np.float32)
    coo = COOMatrix(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals,
        shape=(N_ROWS, N_ROWS),
    ).sum_duplicates()
    d = tmp_path_factory.mktemp("scale")
    mtx = d / "snap_large.mtx"
    from cvr_tpu.io.mmio import write_matrix_market

    write_matrix_market(mtx, coo)
    gz = d / "snap_large.mtx.gz"
    with open(mtx, "rb") as fi, gzip.open(gz, "wb", compresslevel=1) as fo:
        shutil.copyfileobj(fi, fo)
    mtx.unlink()
    return gz, coo


def test_reader_at_scale(snap_large):
    gz, coo = snap_large
    from cvr_tpu.io.mmio import read_matrix_market

    got = read_matrix_market(gz).sum_duplicates()
    assert got.shape == coo.shape and got.nnz == coo.nnz
    a = got.to_csr()
    b = coo.to_csr()
    assert np.array_equal(a.rowptr, b.rowptr)
    assert np.array_equal(a.cols, b.cols)
    np.testing.assert_allclose(a.vals, b.vals, rtol=1e-6)
    assert coo.nnz >= 1_000_000


def test_hub_rows_split_and_pack(snap_large):
    _, coo = snap_large
    csr = coo.to_csr()
    lens = np.diff(csr.rowptr)
    assert lens.max() >= 50_000  # genuine hubs survived dedup
    from cvr_tpu.formats.sell import sell_pack, sell_unpack

    # hub rows exceed any sane split_len -> extra segments exist
    sm = sell_pack(csr, C=1024)
    assert sm.n_splits >= 3 * (50_000 // sm.split_len)
    assert sm.padded_nnz >= csr.nnz
    back = sell_unpack(sm)
    assert np.array_equal(back.rowptr, csr.rowptr)


def test_pack_gates_at_scale(snap_large):
    """Structure gates must reject a power-law graph, not crash."""
    _, coo = snap_large
    csr = coo.to_csr()
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.bell import BellInfeasible, bell_pack
    from cvr_tpu.formats.dia import DiaInfeasible, dia_pack
    from cvr_tpu.formats.sell import SellMatrix

    with pytest.raises(BellInfeasible):
        bell_pack(csr)
    with pytest.raises(DiaInfeasible):
        dia_pack(csr)
    assert isinstance(pack_auto(csr), SellMatrix)


def test_xla_path_and_lane_plan_at_scale(snap_large):
    _, coo = snap_large
    csr = coo.to_csr()
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmv import sell_spmv_xla, to_device
    from cvr_tpu.ops.spmv_ref import (
        spmv_golden_numpy,
        spmv_row_scale,
        verify,
    )

    x = (
        np.random.default_rng(1)
        .standard_normal(csr.shape[1])
        .astype(np.float32)
    )
    sd = to_device(sell_pack(csr, C=1024))
    y = np.asarray(sell_spmv_xla(sd, x))
    ok, nbad, maxrel = verify(
        y, spmv_golden_numpy(csr, x), rtol=1e-6,
        row_scale=spmv_row_scale(csr, x),
    )
    assert ok, (nbad, maxrel)
