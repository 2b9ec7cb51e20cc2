"""Distributed SpMV tests on the virtual 8-device CPU mesh.

The multi-chip answer to the reference's OpenMP thread parallelism
(SURVEY.md §2 'parallelism strategies'): row shards over a Mesh, x
replicated or all-gathered, no cross-device reduction on y.
"""

import numpy as np
import pytest
import jax

from cvr_tpu.parallel.dist import (
    dist_sell_pack,
    dist_spmv,
    dist_spmv_jit,
    make_mesh,
)
from cvr_tpu.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)
from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, verify

from conftest import make_powerlaw_coo, make_random_coo

RTOL = 2e-5


class TestPartition:
    def test_balanced_on_uniform(self):
        rowptr = np.arange(0, 101 * 5, 5, dtype=np.int64)  # 100 rows x 5 nnz
        bounds = partition_rows_by_nnz(rowptr, 4)
        assert bounds[0] == 0 and bounds[-1] == 100
        info = partition_balance(rowptr, bounds)
        assert info["imbalance"] <= 1.05

    def test_powerlaw_imbalance_bounded(self):
        coo = make_powerlaw_coo(5000, 5000, avg_nnz=6, seed=4)
        csr = coo.to_csr()
        bounds = partition_rows_by_nnz(csr.rowptr, 8)
        info = partition_balance(csr.rowptr, bounds)
        # Cutting at row boundaries: imbalance bounded by the largest row.
        assert info["part_nnz"].sum() == csr.nnz
        assert info["imbalance"] < 2.0

    def test_mega_row(self):
        # One row holds ~all nnz; bounds must stay monotone and valid.
        rowptr = np.array([0, 1, 10001, 10002, 10003], dtype=np.int64)
        bounds = partition_rows_by_nnz(rowptr, 4)
        assert (np.diff(bounds) >= 0).all()
        assert bounds[0] == 0 and bounds[-1] == 4

    def test_more_parts_than_rows(self):
        rowptr = np.array([0, 3, 6], dtype=np.int64)
        bounds = partition_rows_by_nnz(rowptr, 8)
        assert bounds.shape == (9,)
        assert bounds[-1] == 2


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


class TestDistSpmv:
    def test_matches_golden_replicated(self, mesh):
        coo = make_powerlaw_coo(4000, 4000, avg_nnz=6, seed=5)
        csr = coo.to_csr()
        dm = dist_sell_pack(csr, mesh, C=128)
        rng = np.random.default_rng(6)
        x = rng.standard_normal(4000).astype(np.float32)
        y = np.asarray(dist_spmv(dm, jax.numpy.asarray(x)))
        ok, nbad, maxrel = verify(
            y, spmv_golden_numpy(csr, x), rtol=RTOL
        )
        assert ok, f"{nbad} bad rows, max rel {maxrel}"

    def test_matches_golden_allgather(self, mesh):
        coo = make_powerlaw_coo(4096, 4096, avg_nnz=5, seed=8)
        csr = coo.to_csr()
        dm = dist_sell_pack(csr, mesh, C=128)
        rng = np.random.default_rng(9)
        x = rng.standard_normal(4096).astype(np.float32)
        from jax.sharding import NamedSharding, PartitionSpec as P

        xs = jax.device_put(x, NamedSharding(mesh, P("shards")))
        y = np.asarray(dist_spmv(dm, xs, x_sharded=True))
        ok, nbad, maxrel = verify(
            y, spmv_golden_numpy(csr, x), rtol=RTOL
        )
        assert ok, f"{nbad} bad rows, max rel {maxrel}"

    def test_jitted_closure(self, mesh):
        coo = make_random_coo(1024, 1024, density=0.01, seed=10)
        csr = coo.to_csr()
        dm = dist_sell_pack(csr, mesh, C=128)
        f = dist_spmv_jit(dm)
        x = np.random.default_rng(1).standard_normal(1024).astype(np.float32)
        y1 = np.asarray(f(jax.numpy.asarray(x)))
        y2 = np.asarray(f(jax.numpy.asarray(2 * x)))
        np.testing.assert_allclose(2 * y1, y2, rtol=1e-5, atol=1e-5)

    def test_rect_and_uneven(self, mesh):
        # nrows not divisible by D, rectangular shape.
        coo = make_random_coo(1003, 777, density=0.02, seed=11)
        csr = coo.to_csr()
        dm = dist_sell_pack(csr, mesh, C=8)
        x = np.random.default_rng(2).standard_normal(777).astype(np.float32)
        y = np.asarray(dist_spmv(dm, jax.numpy.asarray(x)))
        ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=RTOL)
        assert ok, f"{nbad} bad rows, max rel {maxrel}"


def test_dist_xsharded_uneven_ncols():
    """ncols not divisible by the shard count with x_sharded=True (the
    round-1 gap): x is padded to a device multiple before shard_map and
    sliced after the in-shard all-gather."""
    from cvr_tpu.parallel.dist import dist_sell_pack, dist_spmv, make_mesh
    from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

    coo = make_random_coo(1003, 777, density=0.02, seed=11)
    csr = coo.to_csr()
    mesh = make_mesh(8)
    dm = dist_sell_pack(csr, mesh, C=8)
    x = np.random.default_rng(5).standard_normal(777).astype(np.float32)
    y = np.asarray(dist_spmv(dm, x, x_sharded=True))
    ok, nbad, maxrel = verify(
        y, spmv_golden_numpy(csr, x), rtol=1e-6,
        row_scale=spmv_row_scale(csr, x),
    )
    assert ok, (nbad, maxrel)
