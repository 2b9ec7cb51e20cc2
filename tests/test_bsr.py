"""BSR-128 dense-brick SpMM: pack round-trip, batched-matmul correctness
vs a float64 golden, the infeasibility gate, native/NumPy pack parity, and the
spmm dispatcher.  The correctness contract is the reference's in-binary
golden check (spmv.cpp:1916-1938) extended to multi-RHS.
"""

import numpy as np
import pytest

from conftest import make_random_coo

from cvr_tpu.bench.synthetic import banded_matrix
from cvr_tpu.formats.bsr import B, BsrInfeasible, BsrMatrix, bsr_pack
from cvr_tpu.ops.spmm_bsr import spmm_bsr, to_device_bsr
from cvr_tpu.ops.spmv import spmm


def _golden(coo, X):
    m = coo.to_scipy().astype(np.float64)
    gold = m @ X.astype(np.float64)
    scale = abs(m) @ np.abs(X.astype(np.float64)) + 1e-30
    return gold, scale


def _check(coo, K=9, seed=3, tol=1e-6, **kw):
    csr = coo.to_csr()
    bm = bsr_pack(csr, **kw)
    X = (
        np.random.default_rng(seed)
        .standard_normal((coo.shape[1], K))
        .astype(np.float32)
    )
    Y = np.asarray(spmm_bsr(to_device_bsr(bm), X))
    gold, scale = _golden(coo, X)
    maxrel = (np.abs(Y - gold) / scale).max()
    assert maxrel < tol, maxrel
    return bm


def test_bsr_banded():
    bm = _check(banded_matrix(n=2000, bandwidth=9, seed=0))
    assert bm.fill > 0.01
    assert bm.brick_row.shape == (bm.nbricks,)
    # bricks sorted by (row block, col block)
    key = bm.brick_row.astype(np.int64) * (1 << 32) + bm.brick_col
    assert (np.diff(key) > 0).all()


def test_bsr_random_rect():
    _check(make_random_coo(500, 700, density=0.03, seed=4), K=5,
           min_fill=0.0)


def test_bsr_nnz_accounting():
    coo = banded_matrix(n=1500, bandwidth=5, seed=1)
    bm = bsr_pack(coo.to_csr())
    assert bm.nnz == coo.to_csr().nnz
    assert np.count_nonzero(bm.vals) <= bm.nnz
    assert bm.padded_nnz == bm.nbricks * B * B


def test_bsr_infeasible_gate():
    # scattered matrix: ~1 nnz per brick
    coo = make_random_coo(4000, 4000, density=0.0005, seed=5)
    with pytest.raises(BsrInfeasible):
        bsr_pack(coo.to_csr(), min_fill=0.01)
    with pytest.raises(BsrInfeasible):
        bsr_pack(coo.to_csr(), min_fill=0.0, max_bytes=1 << 20)


def test_bsr_native_matches_numpy():
    from cvr_tpu import _native

    if not _native.available():
        pytest.skip("native library unavailable")
    coo = make_random_coo(900, 1100, density=0.02, seed=6)
    csr = coo.to_csr()
    nat = bsr_pack(csr, min_fill=0.0)
    import unittest.mock as mock

    with mock.patch.object(_native, "available", lambda: False):
        ref = bsr_pack(csr, min_fill=0.0)
    assert np.array_equal(nat.brick_row, ref.brick_row)
    assert np.array_equal(nat.brick_col, ref.brick_col)
    assert np.array_equal(nat.vals, ref.vals)


def test_bsr_save_load(tmp_path):
    bm = bsr_pack(banded_matrix(n=1200, bandwidth=7, seed=2).to_csr())
    p = tmp_path / "m.bsr.npz"
    bm.save(p)
    lm = BsrMatrix.load(p)
    assert np.array_equal(lm.vals, bm.vals)
    assert lm.shape == bm.shape and lm.nnz == bm.nnz


def test_bsr_spmm_dispatcher():
    coo = banded_matrix(n=1000, bandwidth=9, seed=3)
    bm = bsr_pack(coo.to_csr())
    X = (
        np.random.default_rng(0)
        .standard_normal((coo.shape[1], 4))
        .astype(np.float32)
    )
    Y = np.asarray(spmm(bm, X))
    gold, scale = _golden(coo, X)
    assert (np.abs(Y - gold) / scale).max() < 1e-6


def _check_pallas(coo, K=17, seed=9, **kw):
    """The jitted dispatcher path at a K that is no power of two."""
    csr = coo.to_csr()
    bm = bsr_pack(csr, **kw)
    X = (
        np.random.default_rng(seed)
        .standard_normal((coo.shape[1], K))
        .astype(np.float32)
    )
    Y = np.asarray(spmm(bm, X))
    gold, scale = _golden(coo, X)
    maxrel = (np.abs(Y - gold) / scale).max()
    assert maxrel < 1e-6, maxrel


def test_bsr_pallas_banded():
    _check_pallas(banded_matrix(n=2000, bandwidth=9, seed=0))


def test_bsr_pallas_rect_and_kpad():
    # non-square, K not a lane multiple, scattered bricks
    _check_pallas(
        make_random_coo(500, 700, density=0.03, seed=4), K=5,
        min_fill=0.0,
    )


def test_bsr_empty_row_block():
    """A 128-row block with no nonzeros at all.

    No occupied brick belongs to it, so its slots in the device layout
    are all zero padding bricks: exact zeros end-to-end on both SpMM
    entries.
    """
    from cvr_tpu.formats.coo import COOMatrix

    # rows [128, 384) form two entirely empty row blocks
    rows = np.array([0, 5, 127, 400, 450, 511], dtype=np.int32)
    cols = np.array([3, 200, 100, 7, 300, 64], dtype=np.int32)
    vals = np.arange(1, 7, dtype=np.float32)
    coo = COOMatrix(rows=rows, cols=cols, vals=vals, shape=(512, 512))
    bm = bsr_pack(coo.to_csr(), min_fill=0.0)
    assert set(bm.brick_row.tolist()) == {0, 3}
    key = bm.brick_row.astype(np.int64) * (1 << 32) + bm.brick_col
    assert (np.diff(key) >= 0).all() and (np.diff(bm.brick_row) >= 0).all()

    X = (
        np.random.default_rng(1)
        .standard_normal((512, 17))
        .astype(np.float32)
    )
    dev = to_device_bsr(bm)
    for fn in (spmm_bsr, spmm):
        Y = np.asarray(fn(dev, X))
        gold, scale = _golden(coo, X)
        assert (np.abs(Y - gold) / scale).max() < 1e-6
        assert (Y[128:384] == 0).all()


def _one_wide_row_block(n=4096):
    """Row block 0 touches every column block; every other row block
    holds one diagonal brick."""
    from cvr_tpu.formats.coo import COOMatrix

    rows = np.concatenate([np.arange(n // B) % B, np.arange(B, n, B)])
    cols = np.concatenate([np.arange(0, n, B), np.arange(B, n, B)])
    vals = np.ones(rows.shape[0], dtype=np.float32)
    return COOMatrix(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                     vals=vals, shape=(n, n))


def test_bsr_gate_counts_device_layout():
    """The gate charges the padded device layout, not the brick count:
    63 occupied bricks fit in 100 bricks' worth of bytes, but the layout
    (32 row blocks x 32 slots) does not."""
    coo = _one_wide_row_block()
    brick = B * B * 4
    with pytest.raises(BsrInfeasible, match="on the device"):
        bsr_pack(coo.to_csr(), min_fill=0.0, max_bytes=100 * brick)
    bm = bsr_pack(coo.to_csr(), min_fill=0.0, max_bytes=32 * 32 * brick)
    assert bm.nbricks == 63
    assert to_device_bsr(bm).vals.shape == (32, 32, B, B)


def test_dist_bsr_gate_counts_stacked_layout():
    from cvr_tpu.parallel.dist_bsr import dist_bsr_pack, make_mesh

    coo = _one_wide_row_block()
    brick = B * B * 4
    with pytest.raises(BsrInfeasible, match="stacked over 8 shards"):
        dist_bsr_pack(coo.to_csr(), make_mesh(8), min_fill=0.0,
                      max_bytes=32 * 32 * brick)
