"""Native (C++/OpenMP) host-runtime tests: parser, CSR assembly, converter.

Every native path must be bit-identical to its NumPy reference — the
native module is a performance substitute, never a semantic fork.
"""

import numpy as np
import pytest

from cvr_tpu import _native
from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.formats.sell import (
    _sell_pack_native,
    _sell_pack_numpy,
    sell_unpack,
)
from cvr_tpu.io.mmio import read_matrix_market, write_matrix_market

from conftest import make_powerlaw_coo, make_random_coo

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native library not built"
)


class TestNativeMtx:
    def test_matches_python_parser(self, tmp_path, random_coo):
        p = tmp_path / "m.mtx"
        write_matrix_market(p, random_coo)
        a = read_matrix_market(p, use_native=True)
        b = read_matrix_market(p, use_native=False)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
        np.testing.assert_allclose(a.vals, b.vals, rtol=1e-6)

    def test_pattern_and_symmetric(self, tmp_path):
        text = (
            "%%MatrixMarket matrix coordinate pattern symmetric\n"
            "% comment\n"
            "3 3 3\n1 1\n2 1\n3 2\n"
        )
        p = tmp_path / "p.mtx"
        p.write_text(text)
        a = read_matrix_market(p, use_native=True)
        b = read_matrix_market(p, use_native=False)
        np.testing.assert_allclose(
            a.to_dense(), b.to_dense(), rtol=1e-6
        )

    def test_integer_field(self, tmp_path):
        p = tmp_path / "i.mtx"
        p.write_text(
            "%%MatrixMarket matrix coordinate integer general\n"
            "2 2 2\n1 2 3\n2 1 -4\n"
        )
        a = read_matrix_market(p, use_native=True)
        np.testing.assert_allclose(sorted(a.vals), [-4.0, 3.0])

    def test_native_error_on_garbage(self, tmp_path):
        p = tmp_path / "g.mtx"
        p.write_text("%%MatrixMarket matrix coordinate real general\n2 2 1\nx y z\n")
        with pytest.raises(Exception):
            _native.mtx_read_native(p)


class TestNativeCsr:
    def test_matches_numpy(self, powerlaw_coo):
        csr_np = powerlaw_coo.to_csr(sort_cols=False)
        rowptr, cols, vals = _native.coo_to_csr_native(
            powerlaw_coo.shape[0],
            powerlaw_coo.rows,
            powerlaw_coo.cols,
            powerlaw_coo.vals,
        )
        np.testing.assert_array_equal(rowptr, csr_np.rowptr)
        np.testing.assert_array_equal(cols, csr_np.cols)
        np.testing.assert_array_equal(vals, csr_np.vals)

    def test_bad_row_index(self):
        with pytest.raises(Exception):
            _native.coo_to_csr_native(
                2,
                np.array([0, 5], dtype=np.int32),
                np.array([0, 1], dtype=np.int32),
                np.array([1.0, 2.0], dtype=np.float32),
            )


class TestNativeSellPack:
    @pytest.mark.parametrize("C,split_len", [(8, 16), (128, 64), (1024, 32)])
    def test_bit_identical_to_numpy(self, C, split_len):
        coo = make_powerlaw_coo(5000, 5000, avg_nnz=7, seed=13)
        csr = coo.to_csr()
        a = _sell_pack_numpy(csr, C, 0, split_len)
        b = _sell_pack_native(csr, C, split_len)
        for name in (
            "vals_plane",
            "cols_plane",
            "slice_offsets",
            "slot_slice",
            "perm",
            "seg_offset",
            "lane_lengths",
            "row_rank",
        ):
            np.testing.assert_array_equal(
                getattr(a, name), getattr(b, name), err_msg=name
            )
        assert a.n_splits == b.n_splits

    def test_no_split(self):
        coo = make_random_coo(500, 500, density=0.02, seed=14)
        csr = coo.to_csr()
        a = _sell_pack_numpy(csr, 128, 0, 0)
        b = _sell_pack_native(csr, 128, 0)
        np.testing.assert_array_equal(a.vals_plane, b.vals_plane)
        np.testing.assert_array_equal(a.row_rank, b.row_rank)
        assert b.n_splits == 0

    def test_unpack_roundtrip(self):
        coo = make_powerlaw_coo(2000, 2000, avg_nnz=6, seed=15)
        csr = coo.to_csr()
        sm = _sell_pack_native(csr, 128, 32)
        back = sell_unpack(sm)
        np.testing.assert_array_equal(back.rowptr, csr.rowptr)
        np.testing.assert_array_equal(back.cols, csr.cols)
        np.testing.assert_array_equal(back.vals, csr.vals)


class TestNativeBuild:
    def test_rebuilds_unless_stamped_with_this_source(self, tmp_path):
        import shutil

        d = tmp_path / "native"
        d.mkdir()
        for name in ("cvr_native.cpp", "Makefile"):
            shutil.copy(_native._SO_PATH.parent / name, d / name)
        so = d / "libcvr_native.so"
        stamp = so.with_suffix(".stamp")
        so.write_bytes(b"built elsewhere")  # no stamp: must be replaced
        assert _native._build_if_needed(so)
        assert so.stat().st_size > 1000
        assert stamp.read_text() == _native.source_hash(d)
        first = so.stat().st_mtime_ns
        # a library stamped with this source's hash is reused as it is
        assert _native._build_if_needed(so)
        assert so.stat().st_mtime_ns == first
        # a library from older source is rebuilt
        src = d / "cvr_native.cpp"
        src.write_text(src.read_text() + "\n// changed\n")
        old = stamp.read_text()
        assert _native._build_if_needed(so)
        assert stamp.read_text() == _native.source_hash(d) != old
