"""One corpus of matrix classes, run across every SELL entry point.

The classes cover what the power-law, locality and hub-column kernels
were built for: hub rows that split into segments, empty rows, one
overlong row, wide and tall rectangles, a band, a road-like sparse band,
an fsm-like matrix with hub columns, and the four SuiteSparse-style
fixtures.  Each runs through the plain SELL SpMV, the SELL SpMM at
K = 1, 8 and 32, pack_auto + spmv, and the row-sharded SpMV on the
8-device CPU mesh, all against the float64 golden at rtol 1e-6 with the
row-scaled bound.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvr_tpu.bench.synthetic import banded_matrix, fsm_like, road_usa_like
from cvr_tpu.formats import pack_auto
from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.formats.sell import sell_pack
from cvr_tpu.io.mmio import read_matrix_market
from cvr_tpu.ops.spmv import sell_spmm_xla, sell_spmv_xla, spmv, to_device
from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

from conftest import make_powerlaw_coo, make_random_coo

FIX = Path(__file__).parent / "fixtures"


def _hub_rows():
    coo = make_powerlaw_coo(2000, 2000, avg_nnz=6, seed=31)
    rng = np.random.default_rng(31)
    hubs = np.repeat(np.array([3, 1500], dtype=np.int32), 900)
    rows = np.concatenate([coo.rows, hubs])
    cols = np.concatenate([coo.cols, rng.integers(0, 2000, hubs.size).astype(np.int32)])
    vals = np.concatenate([coo.vals, rng.standard_normal(hubs.size).astype(np.float32)])
    return COOMatrix(rows, cols, vals, (2000, 2000)).sum_duplicates()


def _empty_rows():
    coo = make_random_coo(600, 500, density=0.02, seed=32)
    keep = coo.rows % 3 != 0  # every third row empty
    return COOMatrix(coo.rows[keep], coo.cols[keep], coo.vals[keep], coo.shape)


def _overlong_row():
    rng = np.random.default_rng(33)
    n = 700
    rows = np.concatenate(
        [np.full(n, 5, dtype=np.int32), rng.integers(0, 300, 900).astype(np.int32)]
    )
    cols = np.concatenate(
        [np.arange(n, dtype=np.int32), rng.integers(0, n, 900).astype(np.int32)]
    )
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return COOMatrix(rows, cols, vals, (300, n)).sum_duplicates()


MATRICES = {
    "hub-rows": _hub_rows,
    "empty-rows": _empty_rows,
    "overlong-row": _overlong_row,
    "wide": lambda: make_random_coo(150, 1300, density=0.02, seed=34),
    "tall": lambda: make_random_coo(1300, 150, density=0.03, seed=35),
    "banded": lambda: banded_matrix(n=3000, bandwidth=9, seed=36),
    "road-like": lambda: road_usa_like(n=1 << 13, deg=2.5, reach=48, seed=37),
    "fsm-like": lambda: fsm_like(n=3000, deg=8, hub_states=64, seed=38),
    "bus240": lambda: read_matrix_market(FIX / "bus240.mtx"),
    "snap300": lambda: read_matrix_market(FIX / "snap300.mtx.gz"),
    "lp150x220": lambda: read_matrix_market(FIX / "lp150x220.mtx"),
    "skew180": lambda: read_matrix_market(FIX / "skew180.mtx"),
}

_CACHE: dict = {}


def _case(name):
    """(csr, x, golden, row scale) per matrix, built once per worker."""
    if name not in _CACHE:
        csr = MATRICES[name]().to_csr()
        x = np.random.default_rng(7).standard_normal(csr.shape[1]).astype(np.float32)
        _CACHE[name] = (csr, x, spmv_golden_numpy(csr, x), spmv_row_scale(csr, x))
    return _CACHE[name]


def _check(name, y):
    _, _, gold, rs = _case(name)
    ok, nbad, err = verify(np.asarray(y), gold, rtol=1e-6, row_scale=rs)
    assert ok, (name, nbad, err)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_corpus_is_its_class(name):
    """The generators make what their names say (guards the corpus)."""
    csr = _case(name)[0]
    lens = csr.row_lengths
    nrows, ncols = csr.shape
    checks = {
        "hub-rows": lambda: sell_pack(csr, C=32).n_splits > 0,
        "empty-rows": lambda: (lens == 0).sum() >= nrows // 3,
        "overlong-row": lambda: lens.max() == ncols,
        "wide": lambda: ncols > 5 * nrows,
        "tall": lambda: nrows > 5 * ncols,
        "banded": lambda: np.abs(csr.cols - np.repeat(np.arange(nrows), lens)).max() <= 4,
        "road-like": lambda: lens.mean() < 3.0,
        "fsm-like": lambda: np.bincount(csr.cols).max() > 20 * lens.mean(),
    }
    assert csr.nnz > 0
    assert checks.get(name, lambda: True)()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_corpus_sell_spmv_xla(name):
    csr, x, _, _ = _case(name)
    _check(name, jax.jit(sell_spmv_xla)(to_device(sell_pack(csr, C=32)), jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_corpus_pack_auto_spmv(name):
    csr, x, _, _ = _case(name)
    _check(name, spmv(pack_auto(csr), x))


@pytest.mark.parametrize("K", [1, 8, 32])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_corpus_sell_spmm_xla(name, K):
    csr = _case(name)[0]
    X = np.random.default_rng(K).standard_normal((csr.shape[1], K)).astype(np.float32)
    Y = np.asarray(jax.jit(sell_spmm_xla)(to_device(sell_pack(csr, C=32)), jnp.asarray(X)))
    m64 = csr.to_scipy().astype(np.float64)
    scale = abs(m64) @ np.abs(X.astype(np.float64))
    assert (np.abs(Y - m64 @ X.astype(np.float64)) <= 1e-6 * (1 + scale)).all()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_corpus_dist_spmv(name):
    from cvr_tpu.parallel.dist import dist_sell_pack, dist_spmv, make_mesh

    csr, x, _, _ = _case(name)
    dm = dist_sell_pack(csr, make_mesh(8), C=32)
    _check(name, jax.jit(lambda v: dist_spmv(dm, v, x_sharded=True))(jnp.asarray(x)))
