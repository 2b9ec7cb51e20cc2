"""Iterative solvers driven by the SpMV kernels.

Conjugate gradient and power iteration: the standard HPC payloads for the
reference's non-scale-free (stencil/FEM) matrix suite (CVR paper Table 2,
"EngSci" domain).  All solvers are jit-traceable with lax control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def conjugate_gradient(
    matvec,
    b: jax.Array,
    x0: jax.Array | None = None,
    tol: float = 1e-6,
    max_iters: int = 1000,
):
    """Solve A x = b for SPD A.  Returns (x, iterations, residual_norm)."""
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = jnp.vdot(r, r)
    b_norm = jnp.maximum(jnp.linalg.norm(b), 1e-30)

    def cond(state):
        _, _, _, rs, it = state
        return jnp.logical_and(
            jnp.sqrt(rs) / b_norm > tol, it < max_iters
        )

    def body(state):
        x, r, p, rs, it = state
        Ap = matvec(p)
        alpha = rs / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, it + 1

    x, r, p, rs, iters = jax.lax.while_loop(
        cond, body, (x, r, p, rs, jnp.int32(0))
    )
    return x, iters, jnp.sqrt(rs) / b_norm


def power_iteration(
    matvec,
    n: int,
    tol: float = 1e-9,
    max_iters: int = 500,
    seed: int = 0,
):
    """Dominant eigenpair of A.  Returns (eigenvalue, eigenvector, iters)."""
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)

    def cond(state):
        _, _, delta, it = state
        return jnp.logical_and(delta > tol, it < max_iters)

    def body(state):
        v, lam, _, it = state
        w = matvec(v)
        lam_new = jnp.vdot(v, w)
        w_norm = jnp.maximum(jnp.linalg.norm(w), 1e-30)
        v_new = w / w_norm
        delta = jnp.abs(lam_new - lam)
        return v_new, lam_new, delta, it + 1

    v, lam, delta, iters = jax.lax.while_loop(
        cond,
        body,
        (v0, jnp.float32(0.0), jnp.float32(jnp.inf), jnp.int32(0)),
    )
    return lam, v, iters


def bicgstab(
    matvec,
    b: jax.Array,
    x0: jax.Array | None = None,
    tol: float = 1e-6,
    max_iters: int = 1000,
):
    """Solve A x = b for general (nonsymmetric) A via BiCGSTAB.

    The nonsymmetric companion to conjugate_gradient — the standard
    solver for the reference's routing/circuit matrices (CVR paper
    Table 2), needing only A @ v products (two per iteration).
    Returns (x, iterations, relative residual norm).  On an exact
    breakdown (rho = 0, r_hat orthogonal to v, or omega = 0 — singular
    or deficient systems) the iteration freezes at the last finite
    iterate instead of spinning NaNs to max_iters.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    r_hat = r  # shadow residual
    b_norm = jnp.maximum(jnp.linalg.norm(b), 1e-30)
    rho = jnp.vdot(r_hat, r)
    p = r
    eps = jnp.float32(1e-30)

    def cond(state):
        _, r, _, _, down, it = state
        return (
            (jnp.linalg.norm(r) / b_norm > tol)
            & (it < max_iters)
            & ~down
        )

    def body(state):
        x, r, p, rho, down, it = state
        v = matvec(p)
        rv = jnp.vdot(r_hat, v)
        rv_broke = jnp.abs(rv) < eps
        alpha = rho / jnp.where(rv_broke, 1.0, rv)
        s = r - alpha * v
        x_h = x + alpha * p  # the valid half-step iterate
        # exact (half-)step convergence is NOT a breakdown: t ~ 0 makes
        # tt/omega degenerate precisely because s already solved the
        # system — keep x_h, don't discard it (A = I converges here in
        # one iteration; the old guard returned x = 0 with res 1.0).
        half = jnp.linalg.norm(s) / b_norm <= tol
        t = matvec(s)
        tt = jnp.vdot(t, t)
        tt_broke = tt < eps
        omega = jnp.vdot(t, s) / jnp.where(tt_broke, 1.0, tt)
        om_broke = tt_broke | (jnp.abs(omega) < eps)
        x_n = x_h + omega * s
        r_n = s - omega * t
        rho_n = jnp.vdot(r_hat, r_n)
        # three outcomes: rv breakdown -> nothing new is defined, keep
        # the old iterate; half-step valid but t-step degenerate (or
        # already converged) -> keep (x_h, s); otherwise the full step.
        use_old = rv_broke
        use_half = ~rv_broke & (half | om_broke)
        x_sel = jnp.where(use_old, x, jnp.where(use_half, x_h, x_n))
        r_sel = jnp.where(use_old, r, jnp.where(use_half, s, r_n))
        stop = use_old | use_half | (jnp.abs(rho_n) < eps)
        beta = (rho_n / jnp.where(jnp.abs(rho) < eps, 1.0, rho)) * (
            alpha / jnp.where(om_broke, 1.0, omega)
        )
        p_n = r_n + beta * (p - omega * v)
        return (
            x_sel, r_sel,
            jnp.where(stop, p, p_n), jnp.where(stop, rho, rho_n),
            stop, it + 1,
        )

    x, r, p, rho, down, iters = jax.lax.while_loop(
        cond, body, (x, r, p, rho, jnp.bool_(False), jnp.int32(0))
    )
    return x, iters, jnp.linalg.norm(r) / b_norm


def jacobi(
    matvec,
    diag: jax.Array,
    b: jax.Array,
    x0: jax.Array | None = None,
    omega: float = 1.0,
    tol: float = 1e-6,
    max_iters: int = 1000,
):
    """(Weighted) Jacobi iteration x <- x + omega D^-1 (b - A x).

    The classic smoother for diagonally dominant stencil systems (the
    reference's banded/EngSci suite) — one SpMV plus elementwise work
    per sweep, a perfect fit for the DIA streaming path.
    Returns (x, iterations, relative residual norm).
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    dinv = omega / diag
    b_norm = jnp.maximum(jnp.linalg.norm(b), 1e-30)
    # carry r = b - A x for the CURRENT x, so the convergence test and
    # the returned residual describe the returned iterate (not the
    # previous one, which would run one extra sweep and over-report).
    r0 = b - matvec(x)

    def cond(state):
        _, r, it = state
        return jnp.logical_and(
            jnp.linalg.norm(r) / b_norm > tol, it < max_iters
        )

    def body(state):
        x, r, it = state
        x = x + dinv * r
        r = b - matvec(x)
        return x, r, it + 1

    x, r, iters = jax.lax.while_loop(cond, body, (x, r0, jnp.int32(0)))
    return x, iters, jnp.linalg.norm(r) / b_norm


def subspace_iteration(
    matmat,
    n: int,
    k: int = 8,
    iters: int = 30,
    seed: int = 0,
):
    """Top-k eigenpairs of symmetric A by block power (subspace)
    iteration — the multi-RHS workload that drives the SpMM paths
    (BASELINE.json config 4).

    matmat: V [n, k] -> A @ V.  Returns (eigenvalues [k], V [n, k]).
    """
    V = jax.random.normal(jax.random.PRNGKey(seed), (n, k), jnp.float32)
    V, _ = jnp.linalg.qr(V)

    def body(_, V):
        W = matmat(V)
        V, _ = jnp.linalg.qr(W)
        return V

    V = jax.lax.fori_loop(0, iters, body, V)
    W = matmat(V)
    # Rayleigh-Ritz on the subspace
    H = V.T @ W
    evals, Q = jnp.linalg.eigh((H + H.T) / 2)
    return evals[::-1], V @ Q[:, ::-1]


def lanczos(
    matvec,
    n: int,
    k: int = 32,
    seed: int = 0,
):
    """k-step Lanczos tridiagonalization of symmetric A (with full
    reorthogonalization — k is small, so the k^2 cost is dwarfed by the
    SpMV and the numerics stay clean in f32).

    matvec: v [n] -> A @ v.  Returns (alpha [k], beta [k-1], V [n, k]):
    eigenvalues of the (alpha, beta) tridiagonal approximate A's extremal
    spectrum — the standard spectral payload (graph Laplacian bounds,
    condition estimates) for the reference's matrix suite.

    jit-traceable: fixed k steps via lax.fori_loop over statically
    shaped carries (columns written with dynamic_update_slice).
    """
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    V = jnp.zeros((n, k), jnp.float32).at[:, 0].set(v0)
    alpha = jnp.zeros(k, jnp.float32)
    beta = jnp.zeros(max(k - 1, 1), jnp.float32)

    def body(j, state):
        V, alpha, beta = state
        v = V[:, j]
        w = matvec(v)
        a = jnp.vdot(v, w)
        w = w - a * v
        # full reorthogonalization against the basis built so far
        # (HIGHEST: a DEFAULT-precision matmul may round operands to
        # TF32 on the GPU, leaving ~1e-3 residual non-orthogonality)
        hp = jax.lax.Precision.HIGHEST
        mask = (jnp.arange(k) <= j).astype(jnp.float32)
        coef = jnp.matmul(V.T, w, precision=hp) * mask
        w = w - jnp.matmul(V, coef, precision=hp)
        b = jnp.linalg.norm(w)
        alpha = alpha.at[j].set(a)
        beta = jnp.where(j < k - 1, beta.at[j].set(b), beta)
        vnext = jnp.where(b > 1e-30, w / jnp.maximum(b, 1e-30), w)
        V = jnp.where(j < k - 1, V.at[:, j + 1].set(vnext), V)
        return V, alpha, beta

    V, alpha, beta = jax.lax.fori_loop(0, k, body, (V, alpha, beta))
    return alpha, beta[: k - 1], V
