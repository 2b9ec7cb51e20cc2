"""The platform decision (cvr_tpu/platform.py) and the peak table
(cvr_tpu/bench/harness.py): the CPU and the GPU are the backends, unknown
backends and unknown device kinds raise instead of falling back."""

import types

import jax
import pytest

from cvr_tpu import platform
from cvr_tpu.bench import harness


def _fake_devices(monkeypatch, plat, kind, n=1):
    devs = [types.SimpleNamespace(platform=plat, device_kind=kind)] * n
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs)


def test_cpu_backend_info():
    info = platform.device_info()
    assert info.platform == "cpu" and info.count == len(jax.devices())


def test_gpu_backend_info(monkeypatch):
    _fake_devices(monkeypatch, "gpu", "NVIDIA H100 80GB HBM3", 4)
    info = platform.device_info()
    assert info.as_dict() == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


@pytest.mark.parametrize("plat", ["neuron", "rocm", "METAL"])
def test_unknown_backend_raises(monkeypatch, plat):
    _fake_devices(monkeypatch, plat, "some accelerator")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.device_info()


def test_power_limit_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(platform.shutil, "which", lambda name: None)
    platform.nvidia_smi_line.cache_clear()
    try:
        assert platform.nvidia_smi_line() is None
        assert platform.power_limit() == "n/a"
    finally:
        platform.nvidia_smi_line.cache_clear()


def test_power_limit_parses_nvidia_smi(monkeypatch):
    monkeypatch.setattr(
        platform, "nvidia_smi_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W"
    )
    assert platform.power_limit() == "700.00 W"


def test_peak_table_h100():
    assert harness.peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "Apple M2", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published HBM bandwidth"):
        harness.peak_hbm_bw(kind)


def test_roofline_share_not_measured_on_cpu():
    cpu = platform.DeviceInfo("cpu", "cpu", 1)
    assert harness.roofline_share(8 * 10**6, 1e-3, cpu) is None
    gpu = platform.DeviceInfo("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert harness.roofline_share(8 * 10**6, 1e-3, gpu) == pytest.approx(8e9 / 3.35e12)
    with pytest.raises(ValueError):
        harness.roofline_share(8 * 10**6, 1e-3, platform.DeviceInfo("gpu", "other", 1))


def test_spmv_bytes_counts_artifact_x_and_y():
    import jax.numpy as jnp
    import numpy as np

    from cvr_tpu.bench.synthetic import banded_matrix
    from cvr_tpu.formats.dia import dia_pack
    from cvr_tpu.ops.spmv_dia import to_device_dia

    dm = dia_pack(banded_matrix(n=1000, bandwidth=5).to_csr())
    x = jnp.zeros(1000, jnp.float32)
    # DIA streams 4 bytes per band slot, not the 8 of a value+column pair
    assert harness.spmv_bytes(to_device_dia(dm), x, 1000) == 5 * 1000 * 4 + 2 * 4000
    assert np.isclose(dm.padded_nnz, 5 * 1000)


@pytest.mark.parametrize("splits", [False, True])
def test_spmv_bytes_sell_counts_only_what_the_spmv_reads(splits):
    import jax.numpy as jnp

    from cvr_tpu.bench.synthetic import banded_matrix, rmat_matrix
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmv import to_device

    coo = (rmat_matrix(scale=10, edge_factor=8, seed=1, cache=False) if splits
           else banded_matrix(n=1024, bandwidth=5))
    sm = sell_pack(coo.to_csr(), split_len=32)
    assert (sm.n_splits > 0) == splits
    sd = to_device(sm)
    # the combine reads perm with splits and row_rank without, never both
    index = sm.perm if splits else sm.row_rank
    assert [a.shape for a in jax.tree.leaves(sd)] == [
        sm.vals_plane.shape, sm.cols_plane.shape, sm.slot_slice.shape, index.shape,
    ]
    x = jnp.zeros(sm.shape[1], jnp.float32)
    read = sm.vals_plane.nbytes + sm.cols_plane.nbytes + sm.slot_slice.nbytes + index.nbytes
    assert harness.spmv_bytes(sd, x, sm.shape[0]) == read + 4 * sm.shape[1] + 4 * sm.shape[0]


@pytest.mark.parametrize(
    "threads, label",
    [(None, "NumPy (no native library)"),
     (0, "native, serial (built without OpenMP)"),
     (16, "native, 16 OpenMP threads")],
)
def test_converter_label(threads, label):
    assert harness.converter_label(threads) == label


def test_report_says_not_measured_on_cpu(capsys):
    r = harness.BenchResult(
        name="m", impl="sell", nnz=1, padded_nnz=1, preproc_s=0.1,
        spmv_s=0.01, iters=1, gflops_2nnz=1.0, gnnz_per_s=0.5,
        roofline_frac=None, amortize_iters=10.0, device_kind="cpu",
        device_count=1,
    )
    r.print_report()
    out = capsys.readouterr().out
    assert "HBM roofline share not measured" in out
    assert "[device: cpu x1, power limit n/a]" in out
