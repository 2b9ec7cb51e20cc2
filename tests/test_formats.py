"""Format-layer tests: COO/CSR containers and the SELL-pack round trip.

Covers the converter edge cases SURVEY.md §7 calls out: empty rows, a
single overlong row (the reference's "steal" case, spmv.cpp:869-943), nnz
not divisible by the lane count, and duplicate coalescing.
"""

import numpy as np
import pytest

from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.formats.sell import SellMatrix, sell_pack, sell_unpack


def csr_equal(a: CSRMatrix, b: CSRMatrix) -> bool:
    return (
        a.shape == b.shape
        and np.array_equal(a.rowptr, b.rowptr)
        and np.array_equal(a.cols, b.cols)
        and np.array_equal(a.vals, b.vals)
    )


class TestCOO:
    def test_to_csr_matches_scipy(self, random_coo):
        ours = random_coo.to_csr()
        ref = random_coo.to_scipy().tocsr()
        assert np.array_equal(ours.rowptr, ref.indptr)
        # scipy sorts columns within rows too (canonical form)
        ref.sort_indices()
        assert np.array_equal(ours.cols, ref.indices)
        np.testing.assert_allclose(ours.vals, ref.data, rtol=1e-7)

    def test_sum_duplicates(self):
        coo = COOMatrix(
            rows=np.array([0, 0, 1, 0]),
            cols=np.array([1, 1, 2, 1]),
            vals=np.array([1.0, 2.0, 3.0, 4.0], dtype=np.float32),
            shape=(2, 3),
        )
        out = coo.sum_duplicates()
        assert out.nnz == 2
        dense = out.to_dense()
        assert dense[0, 1] == 7.0 and dense[1, 2] == 3.0

    def test_roundtrip_csr_coo(self, random_coo):
        csr = random_coo.to_csr()
        back = csr.to_coo().to_csr()
        assert csr_equal(csr, back)


class TestSellPack:
    @pytest.mark.parametrize("C", [8, 128, 1024])
    def test_roundtrip_random(self, random_coo, C):
        csr = random_coo.to_csr()
        sm = sell_pack(csr, C=C)
        assert csr_equal(sell_unpack(sm), csr)

    @pytest.mark.parametrize("sigma", [0, 64, 1000])
    def test_roundtrip_powerlaw(self, powerlaw_coo, sigma):
        csr = powerlaw_coo.to_csr()
        sm = sell_pack(csr, C=128, sigma=sigma)
        assert csr_equal(sell_unpack(sm), csr)

    def test_empty_rows(self):
        # Rows 0, 2, 4 empty.
        coo = COOMatrix(
            rows=np.array([1, 1, 3]),
            cols=np.array([0, 2, 1]),
            vals=np.array([1.0, 2.0, 3.0], dtype=np.float32),
            shape=(5, 3),
        )
        csr = coo.to_csr()
        sm = sell_pack(csr, C=8)
        assert csr_equal(sell_unpack(sm), csr)

    def test_single_overlong_row(self):
        # One row with every column + many tiny rows — the case CVR handles
        # by steal-splitting (spmv.cpp:869-943); here it just defines its
        # slice's width.
        n = 64
        rows = np.concatenate(
            [np.zeros(n, dtype=np.int32), np.arange(1, 9, dtype=np.int32)]
        )
        cols = np.concatenate(
            [np.arange(n, dtype=np.int32), np.zeros(8, dtype=np.int32)]
        )
        vals = np.arange(n + 8, dtype=np.float32) + 1
        csr = COOMatrix(rows, cols, vals, shape=(16, n)).to_csr()
        sm = sell_pack(csr, C=8)
        assert csr_equal(sell_unpack(sm), csr)
        # Longest row must sort first.
        assert sm.perm[0] == 0

    def test_empty_matrix(self):
        csr = COOMatrix(
            rows=np.empty(0, dtype=np.int32),
            cols=np.empty(0, dtype=np.int32),
            vals=np.empty(0, dtype=np.float32),
            shape=(4, 4),
        ).to_csr()
        sm = sell_pack(csr, C=8)
        assert sm.nnz == 0
        assert csr_equal(sell_unpack(sm), csr)

    def test_nnz_balance(self, powerlaw_coo):
        """After splitting + global sort, lanes within each slice must be
        balanced: padding overhead small even on heavy-tailed inputs."""
        csr = powerlaw_coo.to_csr()
        sm = sell_pack(csr, C=128, sigma=0)
        assert sm.fill_ratio < 1.15  # <15% padding on a zipf matrix

    def test_split_roundtrip(self, powerlaw_coo):
        csr = powerlaw_coo.to_csr()
        sm = sell_pack(csr, C=128, split_len=16)
        assert sm.n_splits > 0
        assert csr_equal(sell_unpack(sm), csr)

    def test_split_disabled(self, powerlaw_coo):
        csr = powerlaw_coo.to_csr()
        sm = sell_pack(csr, C=128, split_len=0)
        assert sm.n_splits == 0
        assert csr_equal(sell_unpack(sm), csr)

    def test_explicit_zero_values_preserved(self):
        coo = COOMatrix(
            rows=np.array([0, 0, 1]),
            cols=np.array([0, 1, 0]),
            vals=np.array([0.0, 5.0, 0.0], dtype=np.float32),
            shape=(2, 2),
        )
        csr = coo.to_csr()
        sm = sell_pack(csr, C=8)
        out = sell_unpack(sm)
        assert csr_equal(out, csr)

    def test_save_load(self, tmp_path, random_coo):
        csr = random_coo.to_csr()
        sm = sell_pack(csr, C=128)
        p = tmp_path / "packed.npz"
        sm.save(p)
        sm2 = SellMatrix.load(p)
        assert csr_equal(sell_unpack(sm2), csr)
        assert sm2.C == 128 and sm2.nnz == csr.nnz

    def test_convert_time_reported(self, random_coo):
        sm = sell_pack(random_coo.to_csr())
        assert sm.convert_time > 0
        assert set(sm.convert_phases) in (
            {"split", "sort", "layout", "pack"},  # numpy path
            {"native_pack", "rank"},  # native path
        )


class TestPowerlawFixture:
    def test_is_heavy_tailed(self, powerlaw_coo):
        lengths = powerlaw_coo.to_csr().row_lengths
        assert lengths.max() > 10 * max(lengths.mean(), 1)
