"""Model-layer tests: PageRank, CG, power iteration vs numpy references."""

import numpy as np
import pytest
import jax.numpy as jnp

from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.formats.sell import sell_pack
from cvr_tpu.models.pagerank import pagerank
from cvr_tpu.models.solvers import conjugate_gradient, power_iteration
from cvr_tpu.ops.spmv import sell_spmv_xla, to_device

from conftest import make_powerlaw_coo


def sell_matvec(coo, transpose=False):
    if transpose:
        coo = COOMatrix(coo.cols, coo.rows, coo.vals, (coo.shape[1], coo.shape[0]))
    sd = to_device(sell_pack(coo.to_csr(), C=128))
    return lambda v: sell_spmv_xla(sd, v)


class TestPageRank:
    def test_matches_numpy_power_method(self):
        rng = np.random.default_rng(0)
        n = 300
        # Random graph with ~8 out-links/node.
        rows = np.repeat(np.arange(n, dtype=np.int32), 8)
        cols = rng.integers(0, n, size=8 * n).astype(np.int32)
        vals = np.ones(8 * n, dtype=np.float32)
        adj = COOMatrix(rows, cols, vals, (n, n)).sum_duplicates()

        deg = np.zeros(n)
        np.add.at(deg, adj.rows, adj.vals)
        matvec_T = sell_matvec(adj, transpose=True)
        p, iters, delta = pagerank(
            matvec_T,
            n,
            damping=0.85,
            tol=1e-10,
            max_iters=200,
            out_degree=jnp.asarray(deg.astype(np.float32)),
        )
        p = np.asarray(p)

        # Dense numpy reference.
        A = adj.to_dense().astype(np.float64)
        P = np.divide(A.T, np.maximum(deg, 1), where=deg > 0)
        P[:, deg == 0] = 1.0 / n
        pr = np.full(n, 1.0 / n)
        for _ in range(200):
            pr_new = (1 - 0.85) / n + 0.85 * (P @ pr)
            pr_new /= np.abs(pr_new).sum()
            if np.abs(pr_new - pr).sum() < 1e-12:
                break
            pr = pr_new
        np.testing.assert_allclose(p, pr, rtol=2e-3, atol=1e-6)
        assert int(iters) > 1

    def test_ranks_sum_to_one(self, powerlaw_coo):
        # Unweighted version of the power-law graph (PageRank semantics).
        unweighted = COOMatrix(
            powerlaw_coo.rows,
            powerlaw_coo.cols,
            np.ones(powerlaw_coo.nnz, dtype=np.float32),
            powerlaw_coo.shape,
        )
        n = unweighted.shape[0]
        deg = np.zeros(n, dtype=np.float32)
        np.add.at(deg, unweighted.rows, 1.0)
        matvec_T = sell_matvec(unweighted, transpose=True)
        p, _, _ = pagerank(
            matvec_T, n, out_degree=jnp.asarray(deg), max_iters=50
        )
        assert abs(float(np.asarray(p).sum()) - 1.0) < 1e-3
        assert (np.asarray(p) >= 0).all()


class TestCG:
    def test_solves_spd_system(self):
        rng = np.random.default_rng(1)
        n = 200
        # SPD: diag-dominant sparse symmetric matrix.
        import scipy.sparse as sp

        m = sp.random(n, n, density=0.05, random_state=rng)
        A = (m + m.T) * 0.5 + sp.eye(n) * 10.0
        A = A.tocoo()
        coo = COOMatrix(
            A.row.astype(np.int32),
            A.col.astype(np.int32),
            A.data.astype(np.float32),
            (n, n),
        )
        matvec = sell_matvec(coo)
        b = rng.standard_normal(n).astype(np.float32)
        x, iters, res = conjugate_gradient(
            matvec, jnp.asarray(b), tol=1e-5, max_iters=500
        )
        x_ref = np.linalg.solve(A.toarray(), b.astype(np.float64))
        np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-2, atol=1e-4)
        assert float(res) < 1e-4


class TestPowerIteration:
    def test_dominant_eigenvalue(self):
        rng = np.random.default_rng(2)
        n = 150
        import scipy.sparse as sp

        m = sp.random(n, n, density=0.1, random_state=rng)
        A = ((m + m.T) * 0.5).tocoo()  # symmetric -> real spectrum
        coo = COOMatrix(
            A.row.astype(np.int32),
            A.col.astype(np.int32),
            A.data.astype(np.float32),
            (n, n),
        )
        matvec = sell_matvec(coo)
        lam, v, iters = power_iteration(matvec, n, tol=1e-10, max_iters=2000)
        evals = np.linalg.eigvalsh(A.toarray())
        lam_ref = evals[np.argmax(np.abs(evals))]
        assert abs(abs(float(lam)) - abs(lam_ref)) / abs(lam_ref) < 1e-3


def test_bicgstab_nonsymmetric():
    """BiCGSTAB on a nonsymmetric diagonally dominant band, driven by
    the SpMV dispatcher on what pack_auto picks."""
    import scipy.sparse as sp

    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.models import bicgstab
    from cvr_tpu.ops.spmv import spmv

    n = 3000
    rng = np.random.default_rng(0)
    m = sp.diags(
        [rng.standard_normal(n - 1) * 0.2, np.full(n, 4.0),
         rng.standard_normal(n - 1) * 0.3],
        offsets=[-1, 0, 1], format="coo",
    )
    coo = COOMatrix.from_scipy(m)
    from cvr_tpu.formats import pack_auto

    A = pack_auto(coo.to_csr())
    b = rng.standard_normal(n).astype(np.float32)
    x, iters, res = bicgstab(lambda v: spmv(A, v), jnp.asarray(b))
    assert float(res) < 1e-5
    gold = sp.linalg.spsolve(m.tocsr().astype(np.float64), b)
    assert np.allclose(np.asarray(x), gold, rtol=1e-3, atol=1e-4)


def test_jacobi_banded_dia():
    from cvr_tpu.bench.synthetic import banded_matrix
    from cvr_tpu.formats.dia import dia_pack
    from cvr_tpu.models import jacobi
    from cvr_tpu.ops.spmv_dia import spmv_dia, to_device_dia

    n = 2000
    coo = banded_matrix(n=n, bandwidth=5, seed=3)
    # make it diagonally dominant so Jacobi converges
    import scipy.sparse as sp

    m = coo.to_scipy().tolil()
    m.setdiag(np.abs(m).sum(axis=1).A1 + 1.0)
    from cvr_tpu.formats.coo import COOMatrix

    coo = COOMatrix.from_scipy(m.tocoo())
    csr = coo.to_csr()
    sd = to_device_dia(dia_pack(csr))
    diag = np.asarray(m.diagonal(), dtype=np.float32)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x, iters, res = jacobi(
        lambda v: spmv_dia(sd, v), jnp.asarray(diag), jnp.asarray(b),
        tol=1e-6, max_iters=3000,
    )
    assert float(res) < 1e-5
    r = b - m.tocsr() @ np.asarray(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


def test_subspace_iteration_spmm():
    """Block power iteration through the SpMM dispatcher (multi-RHS)."""
    from cvr_tpu.bench.synthetic import banded_matrix
    from cvr_tpu.models import subspace_iteration
    from cvr_tpu.ops.spmv import spmm
    from cvr_tpu.formats import pack_auto

    n = 1200
    coo = banded_matrix(n=n, bandwidth=7, seed=5)
    # symmetrize
    import scipy.sparse as sp

    m = coo.to_scipy()
    m = ((m + m.T) / 2).tocoo()
    from cvr_tpu.formats.coo import COOMatrix

    A = pack_auto(COOMatrix.from_scipy(m).to_csr())
    evals, V = subspace_iteration(
        lambda X: spmm(A, X), n, k=4, iters=60
    )
    dense = np.asarray(m.todense(), dtype=np.float64)
    true = np.sort(np.linalg.eigvalsh(dense))
    # compare against the top-|lambda| magnitudes (power iteration finds
    # dominant magnitude eigenvalues)
    top_mag = np.sort(np.abs(np.linalg.eigvalsh(dense)))[-1]
    assert abs(abs(float(evals[0])) - top_mag) / top_mag < 5e-2


def test_jacobi_reported_residual_matches_iterate():
    """The returned residual must describe the returned x (the loop once
    reported the PREVIOUS iterate's residual)."""
    from cvr_tpu.models import jacobi

    n = 64
    rng = np.random.default_rng(5)
    A = np.diag(np.full(n, 5.0)) + 0.3 * rng.standard_normal((n, n)) / n
    A = A.astype(np.float32)
    diag = np.ascontiguousarray(np.diag(A))
    b = rng.standard_normal(n).astype(np.float32)
    x, iters, res = jacobi(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(diag), jnp.asarray(b),
        tol=1e-5, max_iters=500,
    )
    true_res = np.linalg.norm(b - A @ np.asarray(x)) / np.linalg.norm(b)
    assert abs(float(res) - true_res) < 1e-6 + 1e-3 * true_res
    assert true_res < 1e-5


def test_bicgstab_breakdown_guard():
    """An exact breakdown (b orthogonal to the Krylov progress, here a
    singular A with b partly outside its range) must not produce NaNs
    (guarded rho / r_hat.v / omega denominators)."""
    from cvr_tpu.models import bicgstab

    n = 32
    A = np.zeros((n, n), np.float32)
    A[: n // 2, : n // 2] = np.eye(n // 2, dtype=np.float32)
    b = np.ones(n, np.float32)
    x, iters, res = bicgstab(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), max_iters=50
    )
    assert np.isfinite(np.asarray(x)).all()
    assert np.isfinite(float(res))


def test_gcn_layer_matches_dense():
    """GCN layer through the SpMM dispatcher vs a dense-numpy reference."""
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.models import gcn_forward, gcn_normalize
    from cvr_tpu.ops.spmv import spmm

    rng = np.random.default_rng(3)
    n, fin, fh, fout = 400, 16, 24, 8
    rows = np.repeat(np.arange(n, dtype=np.int32), 6)
    cols = rng.integers(0, n, size=6 * n).astype(np.int32)
    vals = np.ones(6 * n, dtype=np.float32)
    nr, nc, nv = gcn_normalize(rows, cols, vals, n)
    coo = COOMatrix(nr, nc, nv, (n, n)).sum_duplicates()
    A = pack_auto(coo.to_csr())

    X = rng.standard_normal((n, fin)).astype(np.float32)
    W1 = (rng.standard_normal((fin, fh)) * 0.3).astype(np.float32)
    W2 = (rng.standard_normal((fh, fout)) * 0.3).astype(np.float32)
    out = np.asarray(
        gcn_forward(lambda M: spmm(A, M), jnp.asarray(X), [W1, W2])
    )

    Ad = coo.to_dense().astype(np.float64)
    H = np.maximum(Ad @ (X.astype(np.float64) @ W1), 0.0)
    ref = Ad @ (H @ W2)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_graphsage_layer_matches_dense():
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.models.gnn import graphsage_layer
    from cvr_tpu.ops.spmv import spmm

    rng = np.random.default_rng(7)
    n, fin, fout = 300, 12, 12
    rows = np.repeat(np.arange(n, dtype=np.int32), 5)
    cols = rng.integers(0, n, size=5 * n).astype(np.int32)
    vals = np.ones(5 * n, dtype=np.float32)
    coo = COOMatrix(rows, cols, vals, (n, n)).sum_duplicates()
    # row-normalize (mean aggregation)
    deg = np.zeros(n)
    np.add.at(deg, coo.rows, coo.vals)
    mv = (coo.vals / np.maximum(deg[coo.rows], 1)).astype(np.float32)
    mean = COOMatrix(coo.rows, coo.cols, mv, (n, n))
    A = pack_auto(mean.to_csr())

    X = rng.standard_normal((n, fin)).astype(np.float32)
    Ws = (rng.standard_normal((fin, fout)) * 0.3).astype(np.float32)
    Wn = (rng.standard_normal((fin, fout)) * 0.3).astype(np.float32)
    out = np.asarray(
        graphsage_layer(lambda M: spmm(A, M), jnp.asarray(X), Ws, Wn)
    )
    Ad = mean.to_dense().astype(np.float64)
    ref = np.maximum(X @ Ws + (Ad @ X) @ Wn, 0.0)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_lanczos_extremal_eigenvalues():
    """Lanczos tridiagonal eigenvalues approximate A's extremal spectrum."""
    from cvr_tpu.models import lanczos

    rng = np.random.default_rng(11)
    n = 500
    import scipy.sparse as sp

    d = sp.diags(
        [np.full(n - 1, -1.0), rng.uniform(2.1, 6.0, n), np.full(n - 1, -1.0)],
        [-1, 0, 1],
    ).tocoo()
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.coo import COOMatrix
    from cvr_tpu.ops.spmv import spmv

    A = pack_auto(COOMatrix.from_scipy(d).to_csr())
    alpha, beta, V = lanczos(lambda v: spmv(A, v), n, k=40, seed=1)
    T = np.diag(np.asarray(alpha)) + np.diag(np.asarray(beta), 1) + np.diag(
        np.asarray(beta), -1
    )
    ritz = np.linalg.eigvalsh(T)
    dense = np.asarray(d.todense(), dtype=np.float64)
    true = np.linalg.eigvalsh(dense)
    assert abs(ritz[-1] - true[-1]) / abs(true[-1]) < 1e-3
    assert abs(ritz[0] - true[0]) / max(abs(true[0]), 1e-9) < 2e-2
    # the basis is orthonormal (full reorthogonalization)
    G = np.asarray(V).T @ np.asarray(V)
    np.testing.assert_allclose(G, np.eye(G.shape[0]), atol=1e-4)
