"""BELL (banded-ELL) format: pack gate, kernel, spill, save/load, auto."""

import numpy as np
import pytest

from cvr_tpu.formats.bell import (
    BellInfeasible,
    bell_pack,
    load_bell,
    save_bell,
)
from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.ops.spmv_bell import spmv_bell, to_device_bell
from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify


def _banded(n, deg, reach, seed, ncols=None):
    rng = np.random.default_rng(seed)
    nnz = int(n * deg)
    rows = rng.integers(0, n, nnz).astype(np.int64)
    cols = np.clip(
        rows + rng.integers(-reach, reach + 1, nnz), 0, (ncols or n) - 1
    ).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, ncols or n),
    ).sum_duplicates()


def _check(coo, bm, seed=0):
    csr = coo.to_csr()
    sd = to_device_bell(bm)
    x = np.random.default_rng(seed).standard_normal(
        coo.shape[1]
    ).astype(np.float32)
    y = np.asarray(spmv_bell(sd, x))
    gold = spmv_golden_numpy(csr, x)
    scale = spmv_row_scale(csr, x)
    assert np.abs(y - gold).max() <= 1e-6 * scale.max() + 1e-6 * np.abs(
        gold
    ).max() or verify(y, gold, rtol=1e-4)[0]
    ok, nbad, _ = verify(y, gold, rtol=1e-4)
    assert ok and nbad == 0


def test_bell_road_like():
    coo = _banded(20000, 2.5, 64, 3)
    bm = bell_pack(coo.to_csr())
    assert bm.k <= 8 and bm.reach <= 64
    _check(coo, bm)


def test_bell_wide_reach_and_spill():
    coo = _banded(12000, 4.0, 300, 5)
    bm = bell_pack(coo.to_csr(), k=3, max_spill=1.0)
    assert bm.spill is not None  # deg 4 with k=3 must spill
    _check(coo, bm)


def test_bell_rectangular_wide():
    # wide: ncols > nrows, band hugs the diagonal, far tail spills
    coo = _banded(4096, 2.0, 50, 7, ncols=9000)
    bm = bell_pack(coo.to_csr())
    _check(coo, bm)


def test_bell_spill_runs_through_sell():
    """The residual is a row-compressed SellMatrix whose SpMV is added
    back through spill_map."""
    import jax.numpy as jnp

    from cvr_tpu.formats.sell import SellMatrix
    from cvr_tpu.ops.spmv import sell_spmv_xla, to_device

    coo = _banded(6000, 5.0, 200, 17)
    csr = coo.to_csr()
    bm = bell_pack(csr, k=2, max_spill=1.0)
    assert isinstance(bm.spill, SellMatrix)
    assert bm.spill.shape == (bm.spill_map.size, csr.shape[1])
    assert bm.spill.nnz + int((bm.vals != 0).sum()) == csr.nnz
    x = np.random.default_rng(4).standard_normal(csr.shape[1]).astype(np.float32)
    y_spill = np.zeros(csr.shape[0])
    y_spill[bm.spill_map] = np.asarray(
        sell_spmv_xla(to_device(bm.spill), jnp.asarray(x))
    )
    y = np.asarray(spmv_bell(to_device_bell(bm), x))
    gold = spmv_golden_numpy(csr, x)
    rs = spmv_row_scale(csr, x)
    assert verify(y, gold, rtol=1e-6, row_scale=rs)[0]
    # without the spill's share the planes alone would miss the contract
    assert np.abs(y_spill).max() > 0
    assert not verify(y - y_spill, gold, rtol=1e-6, row_scale=rs)[0]


def test_bell_gate_rejects_powerlaw():
    from cvr_tpu.bench.synthetic import rmat_matrix

    coo = rmat_matrix(scale=12, edge_factor=8, seed=3)
    with pytest.raises(BellInfeasible):
        bell_pack(coo.to_csr())


def test_bell_save_load(tmp_path):
    coo = _banded(10000, 3.0, 64, 11)
    bm = bell_pack(coo.to_csr(), k=2, max_spill=1.0)
    path = tmp_path / "bell.npz"
    save_bell(bm, path)
    bm2 = load_bell(path)
    assert bm2.k == bm.k and bm2.shape == bm.shape
    assert (bm2.spill is None) == (bm.spill is None)
    _check(coo, bm2)


def test_pack_auto_picks_bell_for_sparse_band():
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.bell import BellMatrix

    coo = _banded(20000, 2.5, 64, 13)
    packed = pack_auto(coo.to_csr())
    assert isinstance(packed, BellMatrix)
