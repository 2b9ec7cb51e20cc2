"""DIA format: banded matrices as shifted streaming FMAs (no gathers).

Pack round-trip, SpMV/SpMM vs the f64 golden, the infeasibility gate,
and the pack_auto dispatch (reference analogue of the golden check:
spmv.cpp:1916-1938; CVR's lockstep-streaming best case on regular rows).
"""

import numpy as np
import pytest

from conftest import make_powerlaw_coo, make_random_coo

from cvr_tpu.bench.synthetic import banded_matrix
from cvr_tpu.formats.dia import DiaInfeasible, DiaMatrix, dia_pack
from cvr_tpu.ops.spmv_dia import (
    spmm_dia,
    spmv_dia,
    to_device_dia,
)
from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify


def test_dia_banded_spmv_spmm():
    coo = banded_matrix(n=4000, bandwidth=11, seed=2)
    csr = coo.to_csr()
    dm = dia_pack(csr)
    assert dm.nd == 11
    assert csr.nnz / dm.padded_nnz > 0.9
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    y = np.asarray(spmv_dia(to_device_dia(dm), x))
    ok, nbad, mx = verify(
        y, spmv_golden_numpy(csr, x),
        rtol=1e-6, row_scale=spmv_row_scale(csr, x),
    )
    assert ok, (nbad, mx)
    X = np.random.default_rng(1).standard_normal((4000, 6)).astype(np.float32)
    Y = np.asarray(spmm_dia(to_device_dia(dm), X))
    m64 = coo.to_scipy().astype(np.float64)
    scale = abs(m64) @ np.abs(X) + 1e-30
    assert (np.abs(Y - m64 @ X) / scale).max() < 1e-6


def test_dia_asymmetric_offsets_and_roundtrip(tmp_path):
    # only super-diagonals, including a far one
    n = 600
    rows, cols, vals = [], [], []
    for off in (0, 3, 250):
        r = np.arange(0, n - off)
        rows.append(r); cols.append(r + off)
        vals.append(np.random.default_rng(off).standard_normal(r.shape[0]))
    from cvr_tpu.formats.coo import COOMatrix
    coo = COOMatrix(
        rows=np.concatenate(rows).astype(np.int32),
        cols=np.concatenate(cols).astype(np.int32),
        vals=np.concatenate(vals).astype(np.float32),
        shape=(n, n),
    )
    csr = coo.to_csr()
    dm = dia_pack(csr)
    assert list(dm.offsets) == [0, 3, 250]
    p = tmp_path / "dia.npz"
    dm.save(p)
    dm2 = DiaMatrix.load(p)
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    y = np.asarray(spmv_dia(to_device_dia(dm2), x))
    ok, nbad, mx = verify(
        y, spmv_golden_numpy(csr, x),
        rtol=1e-6, row_scale=spmv_row_scale(csr, x),
    )
    assert ok, (nbad, mx)


def test_dia_rectangular():
    # diagonals of a wide rectangular matrix
    n, m = 500, 800
    r = np.arange(n, dtype=np.int32)
    from cvr_tpu.formats.coo import COOMatrix
    coo = COOMatrix(
        rows=np.concatenate([r, r]).astype(np.int32),
        cols=np.concatenate([r, r + 300]).astype(np.int32),
        vals=np.random.default_rng(0)
        .standard_normal(2 * n)
        .astype(np.float32),
        shape=(n, m),
    )
    csr = coo.to_csr()
    dm = dia_pack(csr)
    x = np.random.default_rng(1).standard_normal(m).astype(np.float32)
    y = np.asarray(spmv_dia(to_device_dia(dm), x))
    ok, nbad, mx = verify(
        y, spmv_golden_numpy(csr, x),
        rtol=1e-6, row_scale=spmv_row_scale(csr, x),
    )
    assert ok, (nbad, mx)


def test_dia_gate_rejects_scattered():
    with pytest.raises(DiaInfeasible):
        dia_pack(make_random_coo(800, 800, density=0.02, seed=1).to_csr())
    with pytest.raises(DiaInfeasible):
        dia_pack(make_powerlaw_coo(2000, 2000, seed=2).to_csr())


def test_pack_auto_picks_dia():
    from cvr_tpu.formats import pack_auto

    packed = pack_auto(banded_matrix(n=3000, bandwidth=7, seed=1).to_csr())
    assert isinstance(packed, DiaMatrix)


def test_dia_dispatchers():
    from cvr_tpu.ops.spmv import spmm, spmv

    coo = banded_matrix(n=2000, bandwidth=5, seed=4)
    csr = coo.to_csr()
    dm = dia_pack(csr)
    x = np.random.default_rng(2).standard_normal(2000).astype(np.float32)
    y = np.asarray(spmv(dm, x))
    ok, _, _ = verify(
        y, spmv_golden_numpy(csr, x),
        rtol=1e-6, row_scale=spmv_row_scale(csr, x),
    )
    assert ok
    X = np.random.default_rng(3).standard_normal((2000, 3)).astype(np.float32)
    Y = np.asarray(spmm(dm, X))
    m64 = coo.to_scipy().astype(np.float64)
    scale = abs(m64) @ np.abs(X) + 1e-30
    assert (np.abs(Y - m64 @ X) / scale).max() < 1e-6


def test_harness_dia_impl():
    from cvr_tpu.bench.harness import run_spmv_benchmark

    coo = banded_matrix(n=3000, bandwidth=9, seed=5)
    r = run_spmv_benchmark(coo, name="band", impl="dia", iters=3)
    assert r.verified
    r2 = run_spmv_benchmark(coo, name="band", impl="auto", iters=3)
    assert r2.verified


def test_dist_dia():
    """Row-sharded DIA over the 8-device mesh, replicated and sharded x
    (uneven ncols)."""
    import jax

    from cvr_tpu.parallel.dist import make_mesh
    from cvr_tpu.parallel.dist_dia import dist_dia_pack, dist_spmv_dia

    coo = banded_matrix(n=3001, bandwidth=9, seed=7)
    csr = coo.to_csr()
    mesh = make_mesh(8)
    dm = dist_dia_pack(csr, mesh)
    x = np.random.default_rng(4).standard_normal(3001).astype(np.float32)
    gold = spmv_golden_numpy(csr, x)
    rs = spmv_row_scale(csr, x)
    for x_sharded in (False, True):
        y = np.asarray(dist_spmv_dia(dm, x, x_sharded=x_sharded))
        ok, nbad, mx = verify(y, gold, rtol=1e-6, row_scale=rs)
        assert ok, (x_sharded, nbad, mx)


def test_cli_dia_save_load(tmp_path, capsys):
    from pathlib import Path

    from cvr_tpu.cli import main
    from cvr_tpu.io.mmio import write_matrix_market

    coo = banded_matrix(n=1200, bandwidth=5, seed=6)
    mtx = tmp_path / "band.mtx"
    write_matrix_market(mtx, coo)
    packed = tmp_path / "band_dia.npz"
    rc = main([
        "spmv", str(mtx), "--format", "dia", "--iters", "2",
        "--save-packed", str(packed),
    ])
    assert rc == 0 and packed.exists()
    capsys.readouterr()
    rc = main([
        "spmv", str(mtx), "--format", "auto", "--iters", "2",
        "--load-packed", str(packed),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Verification: PASS" in out


def test_dia_xla_and_pallas_agree():
    """The shifted-FMA DIA SpMV and the SELL gather SpMV (two independent
    formulations) both meet the golden on a wider band."""
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmv import sell_spmv_xla, to_device

    coo = banded_matrix(n=9000, bandwidth=13, seed=8)
    csr = coo.to_csr()
    sd = to_device_dia(dia_pack(csr))
    x = np.random.default_rng(2).standard_normal(9000).astype(np.float32)
    gold = spmv_golden_numpy(csr, x)
    rs = spmv_row_scale(csr, x)
    ys = {
        "dia": spmv_dia(sd, x),
        "sell": sell_spmv_xla(to_device(sell_pack(csr)), x),
    }
    for name, y in ys.items():
        ok, nbad, mx = verify(np.asarray(y), gold, rtol=1e-6, row_scale=rs)
        assert ok, (name, nbad, mx)


def test_dia_spmm_pallas_and_xla_agree():
    """DIA SpMM (jitted dispatcher and direct) against the SELL SpMM and
    the float64 golden."""
    from cvr_tpu.formats.sell import sell_pack
    from cvr_tpu.ops.spmv import sell_spmm_xla, spmm, to_device

    coo = banded_matrix(n=7000, bandwidth=9, seed=4)
    csr = coo.to_csr()
    dm = dia_pack(csr)
    X = np.random.default_rng(1).standard_normal((7000, 11)).astype(
        np.float32
    )
    m64 = coo.to_scipy().astype(np.float64)
    gold = m64 @ X
    scale = abs(m64) @ np.abs(X) + 1e-30
    Ys = {
        "dispatcher": spmm(dm, X),
        "dia": spmm_dia(to_device_dia(dm), X),
        "sell": sell_spmm_xla(to_device(sell_pack(csr)), X),
    }
    for name, Y in Ys.items():
        assert (np.abs(np.asarray(Y) - gold) / scale).max() < 1e-6, name


def test_dia_wide_rectangular_pallas():
    """Wide rectangular matrices (ncols far beyond the reachable rows):
    the padded x/X tail must not go negative (jnp.pad ValueError)."""
    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.ops.spmv import spmm

    n, m = 1000, 3000
    r = np.arange(n, dtype=np.int32)
    coo = COOMatrix(
        rows=r,
        cols=(r + 500).astype(np.int32),
        vals=np.random.default_rng(0).standard_normal(n).astype(np.float32),
        shape=(n, m),
    )
    csr = coo.to_csr()
    dm = dia_pack(csr)
    m64 = coo.to_scipy().astype(np.float64)

    X = np.random.default_rng(1).standard_normal((m, 5)).astype(np.float32)
    gold = m64 @ X
    scale = abs(m64) @ np.abs(X) + 1e-30
    for Y in (spmm(dm, X), spmm_dia(to_device_dia(dm), X)):
        assert (np.abs(np.asarray(Y) - gold) / scale).max() < 1e-6

    # SpMV with ncols far beyond the padded x length
    coo_w = COOMatrix(
        rows=r, cols=(r + 500).astype(np.int32),
        vals=coo.vals, shape=(n, 40000),
    )
    csr_w = coo_w.to_csr()
    sd_w = to_device_dia(dia_pack(csr_w))
    x = np.random.default_rng(2).standard_normal(40000).astype(np.float32)
    y = np.asarray(spmv_dia(sd_w, x))
    ok, nbad, mx = verify(
        y, spmv_golden_numpy(csr_w, x),
        rtol=1e-6, row_scale=spmv_row_scale(csr_w, x),
    )
    assert ok, (nbad, mx)
