"""Benchmark harness: preproc time, SpMV time, GFLOPS, nnz/s, roofline.

Reproduces the reference's benchmark protocol — N timed iterations of
y = A @ x, mean time, throughput (spmv.cpp:1024,1656-1664) — with its
machine-greppable stdout contract: lines tagged ``Pre-processing``,
``SpMV Execution`` and ``Throughput`` (README.md:47-49,
run_comparison.sh:47-49).

GFLOPS conventions: the reference is inconsistent (CVR/VHCC print 1
flop/nnz over *padded* nnz, spmv.cpp:1664, while CSR5's results.csv uses
2*nnz, csr5/detail/utils.h:16-20).  This harness reports BOTH, computed
over true (unpadded) nnz, and labels them — SURVEY.md §5 "unit trap".

The roofline: one SpMV must read the packed device artifact once (every
array of it, since each device type holds only what its SpMV reads: SELL
planes at 8 bytes/slot plus the slice ids and the combine index, DIA
bands at 4, ...), read x and write y, so its speed-of-light time is ``bytes_per_spmv / peak HBM
bandwidth``; ``roofline_frac`` reports the achieved fraction against the
published peak of the device kind (HBM_BW).  x-gather re-reads that hit
the cache are not counted.  On the CPU backend it is None and prints as
"not measured".
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# Published peak HBM bandwidth (bytes/s), keyed by jax device_kind.
# NVIDIA H100 SXM5 80GB: 3.35 TB/s HBM3 (NVIDIA H100 Tensor Core GPU
# data sheet).
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bw(device_kind: str) -> float:
    """Published HBM bandwidth of ``device_kind``; unknown kinds raise."""
    try:
        return HBM_BW[device_kind]
    except KeyError:
        raise ValueError(
            f"no published HBM bandwidth for device kind {device_kind!r}; "
            "add it to cvr_tpu.bench.harness.HBM_BW with its source"
        ) from None


def spmv_bytes(sd, x, nrows: int) -> int:
    """Bytes one SpMV must move: the device artifact (every array of it is
    read), x in, y out (f32)."""
    return sum(a.nbytes for a in jax.tree.leaves(sd)) + x.nbytes + 4 * nrows


def roofline_share(bytes_per_spmv: int, spmv_s: float, info) -> float | None:
    """bytes_per_spmv / spmv_s over the device's peak; None on the CPU."""
    if info.platform == "cpu":
        return None
    return (bytes_per_spmv / spmv_s) / peak_hbm_bw(info.kind)


def converter_label(native_threads: int | None) -> str:
    """What timed the pack, in words (see BenchResult.native_threads)."""
    if native_threads is None:
        return "NumPy (no native library)"
    if native_threads == 0:
        return "native, serial (built without OpenMP)"
    return f"native, {native_threads} OpenMP threads"


@dataclass
class BenchResult:
    name: str
    impl: str
    nnz: int
    padded_nnz: int
    preproc_s: float
    spmv_s: float  # mean per-iteration
    iters: int
    gflops_2nnz: float  # 2*nnz / t / 1e9  (CSR5 convention)
    gnnz_per_s: float  # nnz / t / 1e9    (CVR prints this as "GFLOPS")
    roofline_frac: float | None  # None on the CPU backend
    amortize_iters: float  # preproc_s / spmv_s (CVR: ~2.14, paper Table 1)
    verified: bool | None = None
    max_rel_err: float | None = None
    nrows: int = 0
    ncols: int = 0
    # First-run pack time when pack_repeats > 1 (preproc_s is then the
    # min over repeats — the algorithm's time; the first run also pays
    # first-touch page faults).
    preproc_first_s: float | None = None
    device_kind: str = ""
    device_count: int = 0
    power_limit: str = "n/a"
    bytes_per_spmv: int = 0  # see spmv_bytes
    # Threads of the native converter that timed the pack: 0 = built
    # without OpenMP (serial), None = no native library (NumPy packers).
    native_threads: int | None = None

    def print_report(self, threads_label: str = "1chip") -> None:
        # Greppable contract mirroring README.md:47-49.
        roof = (
            "not measured"
            if self.roofline_frac is None
            else f"{100 * self.roofline_frac:.1f}%"
        )
        print(
            f"[file: {self.name}] [device: {self.device_kind} "
            f"x{self.device_count}, power limit {self.power_limit}] "
            f"[converter: {converter_label(self.native_threads)}]"
        )
        first = (
            f" (min over repeats; first run {self.preproc_first_s * 1e3:.3f} ms)"
            if self.preproc_first_s is not None
            else ""
        )
        print(
            f"[file: {self.name}] [threads: {threads_label}] "
            f"Pre-processing Time: {self.preproc_s * 1e3:.3f} ms{first}"
        )
        print(
            f"[file: {self.name}] [threads: {threads_label}] "
            f"SpMV Execution Time: {self.spmv_s * 1e3:.6f} ms"
        )
        print(
            f"[file: {self.name}] [threads: {threads_label}] "
            f"Throughput: {self.gflops_2nnz:.3f} GFlops (2*nnz), "
            f"{self.gnnz_per_s:.3f} Gnnz/s, "
            f"HBM roofline share {roof}"
        )
        if self.verified is not None:
            print(
                f"[file: {self.name}] Verification: "
                + ("PASS" if self.verified else "FAIL")
                + (
                    f" (max rel err {self.max_rel_err:.2e})"
                    if self.max_rel_err is not None
                    else ""
                )
            )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def make_iterated(spmv_like, n, scale: float = 1.0, out_n: int | None = None):
    """ONE jit call = ``iters`` SpMV passes as a power iteration, from a
    PRNG-seeded start vector.

    The loop is a genuine power iteration v <- scale * (A @ v): a fake
    dependence like ``x + 0*y`` is simplified away by XLA and the whole
    loop dies.  ``scale`` ~ 1/||A||_inf keeps v bounded; it fuses into
    the epilogue.  ``iters`` is a DYNAMIC argument, so one compile serves
    every loop length.  Returns a jitted fn(A, seed, iters) -> sum(v).
    """

    def run(A, seed, iters):
        v0 = jax.random.normal(jax.random.PRNGKey(seed), n, jnp.float32)

        if out_n is None or out_n == n[0]:
            def body(_, v):
                return spmv_like(A, v) * scale
        else:
            # Rectangular A (r x c): iterate on a max(r, c)-long carry —
            # slice the kernel input to c, zero-pad its output back.  The
            # slice/pad fuse into the epilogue, so only A's own cost is
            # in the loop (the reference benchmarks any .mtx; its scalar
            # loop has no squareness constraint, spmv.cpp:1843-1850).
            N = max(out_n, n[0])
            pad_in = [(0, N - n[0])] + [(0, 0)] * (len(n) - 1)
            pad_out = [(0, N - out_n)] + [(0, 0)] * (len(n) - 1)
            v0 = jnp.pad(v0, pad_in)

            def body(_, v):
                y = spmv_like(A, v[: n[0]]) * scale
                return jnp.pad(y, pad_out)

        v = jax.lax.fori_loop(0, iters, body, v0, unroll=False)
        return jnp.sum(v)

    return jax.jit(run)


def time_fn_iterated(
    spmv_like,
    A,
    x,
    iters: int,
    repeats: int = 2,
    scale: float = 1.0,
    min_loop_s: float = 0.4,
    out_n: int | None = None,
) -> float:
    """Per-iteration seconds via the slope between a short and a long
    on-device power-iteration loop (see make_iterated).

    The slope cancels the fixed cost of a call (dispatch, the start
    vector, the final reduction).  The loop length auto-calibrates so
    each timed loop runs for at least ``min_loop_s``; ``iters`` is only
    the starting point.
    """
    n = tuple(x.shape)  # vector [ncols] or multi-RHS [ncols, K]
    run = make_iterated(spmv_like, n, scale=scale, out_n=out_n)

    def timed(L, seed):
        t0 = time.perf_counter()
        jax.block_until_ready(run(A, jnp.int32(seed), jnp.int32(L)))
        return time.perf_counter() - t0

    _ = timed(1, 0)  # compile
    L1 = max(1, iters // 5)
    w = timed(L1, 1)
    while w < min_loop_s and L1 < (1 << 22):
        L1 *= 4
        w = timed(L1, 1)
    L2 = 5 * L1
    t1 = float("inf")
    t2 = float("inf")
    for i in range(1, repeats + 1):
        t1 = min(t1, timed(L1, 10 + i))
        t2 = min(t2, timed(L2, 100 + i))
    return max(t2 - t1, 1e-12) / (L2 - L1)


def _timed_pack(fn, repeats: int = 1):
    """Run the pack ``repeats`` times; return (result, min_s, first_s).

    The first pack also pays first-touch page faults of its temporaries;
    min-over-repeats is the algorithm's time.  Both numbers are reported
    so neither hides.
    """
    best = float("inf")
    first = None
    out = None
    for _ in range(max(1, repeats)):
        # Drop the previous repeat's result before packing again — holding
        # both roughly doubles peak host memory on --full-scale matrices.
        out = None
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        if first is None:
            first = dt
        best = min(best, dt)
    return out, best, first


def run_spmv_benchmark(
    coo,
    name: str = "matrix",
    impl: str = "auto",
    iters: int = 100,
    C: int | None = None,
    sigma: int = 0,
    verify_result: bool = True,
    x: np.ndarray | None = None,
    pack_repeats: int = 1,
) -> BenchResult:
    """End-to-end: convert (timed) -> SpMV iterations (timed) -> verify.

    impl: "auto" (pack_auto: DIA -> BELL -> SELL), "sell", "dia", "bell"
    or "csr".  Mirrors the reference program's sequence read -> convert ->
    compute -> verify -> report (spmv.cpp:1675-1948).
    """
    from cvr_tpu import _native, platform
    from cvr_tpu.formats import pack_auto
    from cvr_tpu.formats.bell import bell_pack
    from cvr_tpu.formats.dia import dia_pack
    from cvr_tpu.formats.sell import DEFAULT_C, sell_pack
    from cvr_tpu.ops.spmv_ref import (
        spmv_csr_jnp,
        spmv_golden_numpy,
        spmv_row_scale,
        verify,
    )
    from cvr_tpu.utils import memarena

    # Lazily-backed VM memory makes cold numpy temporaries ~100x slow
    # (utils/memarena.py); warm the allocator arena before the convert
    # timer so the pack measures the algorithm, not the hypervisor.
    memarena.warm()
    memarena.wait()

    info = platform.device_info()
    csr = coo.to_csr()
    nnz = csr.nnz
    nrows = csr.shape[0]
    if x is None:
        # Reference fixture: constant x = 1.0 (spmv.cpp:556-563).
        x = np.ones(csr.shape[1], dtype=csr.vals.dtype)
    # Keep the power iteration bounded: scale ~ 1 / ||A||_inf.
    row_abs = np.bincount(
        csr.row_ids(), weights=np.abs(csr.vals.astype(np.float64)),
        minlength=nrows,
    )
    norm_inf = float(row_abs.max()) if nrows else 0.0
    pi_scale = 1.0 / norm_inf if norm_inf > 0 else 1.0

    if impl == "csr":
        def pack():
            return (
                jnp.asarray(csr.rowptr),
                jnp.asarray(csr.cols),
                jnp.asarray(csr.vals),
            )

        def kernel(A, v):
            return spmv_csr_jnp(A[0], A[1], A[2], v, nrows)
    else:
        from cvr_tpu.ops.spmv import spmv_fn_of

        pack = {
            "auto": lambda: pack_auto(csr),
            "sell": lambda: sell_pack(csr, C=C or DEFAULT_C, sigma=sigma),
            "dia": lambda: dia_pack(csr),
            "bell": lambda: bell_pack(csr),
        }.get(impl)
        if pack is None:
            raise ValueError(f"unknown impl {impl!r}")
    packed, preproc, preproc_first = _timed_pack(pack, pack_repeats)
    if impl == "csr":
        sd, padded = packed, nnz
    else:
        padded = packed.padded_nnz
        sd, kernel = spmv_fn_of(packed)
    xd = jnp.asarray(x)
    nbytes = spmv_bytes(sd, xd, nrows)
    spmv_s = time_fn_iterated(
        kernel, sd, xd, iters=iters, scale=pi_scale, out_n=nrows
    )
    y = np.asarray(jax.jit(kernel)(sd, xd))

    ok = None
    max_rel = None
    if verify_result:
        y_ref = spmv_golden_numpy(csr, x)
        ok, _nbad, max_rel = verify(
            y, y_ref, rtol=1e-6, row_scale=spmv_row_scale(csr, x)
        )

    return BenchResult(
        name=name,
        impl=impl if impl != "auto" else f"auto:{type(packed).__name__}",
        nnz=nnz,
        padded_nnz=padded,
        preproc_s=preproc,
        spmv_s=spmv_s,
        iters=iters,
        gflops_2nnz=2 * nnz / spmv_s / 1e9,
        gnnz_per_s=nnz / spmv_s / 1e9,
        roofline_frac=roofline_share(nbytes, spmv_s, info),
        amortize_iters=preproc / spmv_s if spmv_s > 0 else float("inf"),
        verified=ok,
        max_rel_err=max_rel,
        nrows=nrows,
        ncols=csr.shape[1],
        preproc_first_s=preproc_first if pack_repeats > 1 else None,
        device_kind=info.kind,
        device_count=info.count,
        power_limit=platform.power_limit(),
        bytes_per_spmv=nbytes,
        native_threads=_native.omp_threads(),
    )
