"""Test configuration.

Tests run on a virtual 8-device CPU mesh so the distributed (shard_map)
code paths are exercised without a GPU — the multi-device answer to the
reference's single-machine OpenMP testing (SURVEY.md §4).  Env vars must
be set before jax is imported by any test module; JAX_PLATFORMS defaults
to cpu here, and a caller that sets it (JAX_PLATFORMS=cuda pytest -m gpu)
or that already started JAX on the GPU (chip_smoke.py) keeps its own.

Tests marked ``gpu`` need the card; the ``gpu`` fixture decides at run
time whether one is there and skips otherwise.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Persistent compilation cache: caching compiled executables across test
# processes and runs cuts full-suite wall clock.
from cvr_tpu.utils.compilecache import enable as _enable_cache

_enable_cache()

import numpy as np
import pytest
import scipy.sparse as sp

from cvr_tpu.formats.coo import COOMatrix


def make_random_coo(
    nrows, ncols, density=0.05, seed=0, dtype=np.float32
) -> COOMatrix:
    rng = np.random.default_rng(seed)
    m = sp.random(
        nrows,
        ncols,
        density=density,
        format="coo",
        random_state=rng,
        data_rvs=lambda n: rng.standard_normal(n),
    )
    return COOMatrix(
        rows=m.row.astype(np.int32),
        cols=m.col.astype(np.int32),
        vals=m.data.astype(dtype),
        shape=(nrows, ncols),
    )


def make_powerlaw_coo(nrows, ncols, avg_nnz=6, alpha=1.8, seed=0) -> COOMatrix:
    """Power-law row-degree matrix — the load-imbalance stressor the CVR
    format exists for (scale-free graphs, paper Table 2)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(
        rng.zipf(alpha, size=nrows), ncols
    )  # heavy-tailed degrees
    scale = avg_nnz / max(deg.mean(), 1.0)
    deg = np.maximum((deg * scale).astype(np.int64), 0)
    deg = np.minimum(deg, ncols)
    rows = np.repeat(np.arange(nrows, dtype=np.int32), deg)
    cols = rng.integers(0, ncols, size=rows.shape[0]).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return COOMatrix(rows=rows, cols=cols, vals=vals, shape=(nrows, ncols)).sum_duplicates()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run by chip_smoke.py)"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is the GPU (decided per test)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run python chip_smoke.py on the card")


@pytest.fixture
def random_coo():
    return make_random_coo(200, 180, density=0.05, seed=1)


@pytest.fixture
def powerlaw_coo():
    return make_powerlaw_coo(3000, 3000, avg_nnz=6, seed=2)
