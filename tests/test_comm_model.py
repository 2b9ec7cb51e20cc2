"""Comm-volume model sanity (hardware-free weak-scaling projection)."""

import numpy as np

from cvr_tpu.parallel.comm_model import (
    NVLINK_BW,
    comm_table,
    knee_devices,
    sell_stream_bytes,
    weak_scaling,
)

# An illustrative one-card SpMV time and web-Google's column count; the
# model's arithmetic is what is checked, not a measurement.
T_COMP, NCOLS = 1.0e-3, 916_428


def test_weak_scaling_monotone_and_overlap_dominates():
    prev_b = prev_o = 1.1
    for d in (2, 4, 8, 16, 64, 256):
        t_comm, e_b, e_o = weak_scaling(T_COMP, NCOLS, d)
        assert t_comm == (d - 1) * NCOLS * 4 / NVLINK_BW
        assert 0 < e_b <= prev_b + 1e-12
        assert 0 < e_o <= prev_o + 1e-12
        # overlap can only help (hides comm behind the compute)
        assert e_o >= e_b - 1e-12
        prev_b, prev_o = e_b, e_o


def test_single_device_is_free():
    t_comm, e_b, e_o = weak_scaling(1e-3, 10**6, 1)
    assert t_comm == 0.0
    assert e_b == 1.0 and e_o == 1.0


def test_knee_is_past_eight_for_bench_domains():
    # at 450 GB/s each way, gathering a web-Google-length x costs ~8 us
    # per extra card: a 1 ms SpMV keeps E >= 70% well past one host
    kb, ko = knee_devices(T_COMP, NCOLS)
    assert kb >= 8 and ko >= kb


def test_comm_table_skips_shapeless_rows():
    rows = [
        {"name": "old", "nnz": 10, "padded_nnz": 12, "spmv_s": 1e-3},
        {
            "name": "new",
            "ncols": 1000,
            "nnz": 10,
            "padded_nnz": 12,
            "spmv_s": 1e-3,
        },
    ]
    out = comm_table(rows, D=8)
    assert [c.name for c in out] == ["new"]
    c = out[0]
    assert c.gather_bytes == 7 * 1000 * 4
    assert c.stream_bytes == sell_stream_bytes(12) == 96
    assert np.isfinite(c.eff_blocking) and c.eff_overlap >= c.eff_blocking
