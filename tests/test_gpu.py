"""Checks that only the card can make: compiled GPU code against the
float64 golden at sizes where the GPU's own choices show (atomic
scatter-add order, cuBLAS precision).  They skip on the CPU backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvr_tpu.bench.synthetic import banded_matrix, rmat_matrix
from cvr_tpu.formats.bsr import bsr_pack
from cvr_tpu.formats.sell import sell_pack
from cvr_tpu.ops.spmm_bsr import spmm_bsr, to_device_bsr
from cvr_tpu.ops.spmv import sell_spmv_xla, to_device
from cvr_tpu.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify


@pytest.mark.gpu
def test_gpu_sell_spmv_scatter_add_meets_contract(gpu):
    """Split hub rows combine through an atomic scatter-add on the GPU;
    its varying summation order must still meet rtol 1e-6."""
    csr = rmat_matrix(scale=18, edge_factor=8, seed=5, cache=False).to_csr()
    sm = sell_pack(csr)
    assert sm.n_splits > 0
    x = np.random.default_rng(1).standard_normal(csr.shape[1]).astype(np.float32)
    f = jax.jit(sell_spmv_xla)
    sd = to_device(sm)
    gold, rs = spmv_golden_numpy(csr, x), spmv_row_scale(csr, x)
    for _ in range(3):
        ok, nbad, err = verify(np.asarray(f(sd, jnp.asarray(x))), gold, rtol=1e-6, row_scale=rs)
        assert ok, (nbad, err)


@pytest.mark.gpu
def test_gpu_bsr_highest_is_full_f32(gpu):
    """Precision.HIGHEST keeps the batched brick matmul out of TF32."""
    coo = banded_matrix(n=1 << 16, bandwidth=27, seed=2)
    X = np.random.default_rng(3).standard_normal((coo.shape[1], 128)).astype(np.float32)
    Y = np.asarray(spmm_bsr(to_device_bsr(bsr_pack(coo.to_csr())), jnp.asarray(X)))
    m64 = coo.to_scipy().astype(np.float64)
    scale = abs(m64) @ np.abs(X.astype(np.float64))
    assert (np.abs(Y - m64 @ X.astype(np.float64)) <= 1e-6 * (1 + scale)).all()
