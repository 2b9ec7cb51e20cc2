"""Deterministic synthetic matrices for benchmarking.

The reference benchmarks on SuiteSparse/SNAP downloads (run_sample.sh:5-8).
This environment has no network egress, so the harness ships a deterministic
R-MAT generator whose outputs match the *statistics* the CVR paper's
scale-free suite stresses (power-law row degrees, ~5 nnz/row, web-scale row
counts — web-Google is 916K x 916K with 5.10M nnz, paper Table 2).  Real
.mtx files are used instead whenever present in the cache.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from cvr_tpu.formats.coo import COOMatrix


def _cache_dir() -> Path:
    d = Path(
        os.environ.get("CVR_TPU_CACHE", Path.home() / ".cache" / "cvr_tpu")
    )
    d.mkdir(parents=True, exist_ok=True)
    return d


def rmat_matrix(
    scale: int,
    edge_factor: int = 6,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 42,
    dtype=np.float32,
    cache: bool = True,
) -> COOMatrix:
    """R-MAT power-law graph: 2**scale vertices, edge_factor * 2**scale edges.

    Kronecker quadrant probabilities (a, b, c, 1-a-b-c) follow the Graph500
    convention; duplicates are coalesced, so the final nnz is slightly below
    the nominal edge count (like real web crawls).  Deterministic for a
    given seed; large instances are cached on disk.
    """
    n = 1 << scale
    nnz = edge_factor * n
    key = f"rmat_s{scale}_e{edge_factor}_a{a}_b{b}_c{c}_seed{seed}.npz"
    cpath = _cache_dir() / key
    if cache and scale >= 16 and cpath.exists():
        z = np.load(cpath)
        return COOMatrix(
            rows=z["rows"],
            cols=z["cols"],
            vals=z["vals"].astype(dtype),
            shape=(n, n),
        )

    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    rows = np.zeros(nnz, dtype=np.int32)
    cols = np.zeros(nnz, dtype=np.int32)
    # Inverse-CDF sampling of the quadrant, one f32 uniform draw per
    # level: q = #{cdf_k < u} (searchsorted's answer, in three compares).
    cdf = np.cumsum([a, b, c, d])[:3].astype(np.float32)
    for _level in range(scale):
        u = rng.random(nnz, dtype=np.float32)
        q = (u > cdf[0]).astype(np.int32)
        q += u > cdf[1]
        q += u > cdf[2]
        rows <<= 1
        rows |= q >> 1
        cols <<= 1
        cols |= q & 1
    vals = rng.standard_normal(nnz).astype(dtype)
    coo = COOMatrix(rows=rows, cols=cols, vals=vals, shape=(n, n)).sum_duplicates()
    if cache and scale >= 16:
        np.savez(cpath, rows=coo.rows, cols=coo.cols, vals=coo.vals)
    return coo


def web_google_like(seed: int = 42) -> COOMatrix:
    """A deterministic stand-in for web-Google (916K x 916K, 5.10M nnz,
    power-law degrees — paper Table 2): R-MAT scale 20, edge factor 6,
    coalesced to ~5M nnz."""
    return rmat_matrix(scale=20, edge_factor=6, seed=seed)


def wiki_talk_like(seed: int = 7) -> COOMatrix:
    """A deterministic stand-in for wiki-Talk (2.39M x 2.39M, 5.02M nnz,
    extreme in-degree skew — the matrix family where CVR's record/steal
    machinery matters most, paper Table 2): steeper R-MAT quadrants
    produce celebrity columns/rows with 10^4-10^5 nonzeros."""
    return rmat_matrix(
        scale=21, edge_factor=3, a=0.65, b=0.15, c=0.15, seed=seed
    )


def soc_livejournal_like(seed: int = 11) -> COOMatrix:
    """Mid-scale stand-in for soc-LiveJournal1-class social graphs
    (~4.2M x 4.2M, ~25M nnz) — the quick-turnaround social benchmark."""
    return rmat_matrix(scale=22, edge_factor=6, seed=seed)


def soc_livejournal_full(seed: int = 11) -> COOMatrix:
    """Full-scale stand-in for soc-LiveJournal1 (4.8M x 4.8M, 69M nnz,
    paper Table 2): R-MAT scale 23, edge factor 9, coalesced to ~65M
    nnz.  Exercises the routed path beyond the former 33M single-chip
    cap (the route's host mid plane is int32 now)."""
    return rmat_matrix(scale=23, edge_factor=9, seed=seed)


def citation_like(seed: int = 13) -> COOMatrix:
    """Stand-in for the citation domain (cit-Patents-class: moderate
    power-law, ~15 nnz/row — paper Table 2): milder R-MAT quadrants at
    web scale."""
    return rmat_matrix(
        scale=20, edge_factor=16, a=0.55, b=0.2, c=0.2, seed=seed
    )


def fsm_like(
    n: int = 1 << 21, deg: int = 8, hub_states: int = 1024,
    reach: int = 64, p_fail: float = 0.55, seed: int = 19,
) -> COOMatrix:
    """Stand-in for the FSM domain (CGO'18 Table 2/3: automata transition
    matrices from pattern-matching FSMs; reference CVR avg 8.09 GFLOPS).

    Structural fingerprint of an Aho-Corasick-style automaton: near-
    constant row out-degree (the stored alphabet transitions), columns
    split between FORWARD trie edges (state + small offset — spatial
    locality) and FAILURE links back to a tiny set of shallow states near
    the root (extreme column reuse).  p_fail of the transitions land on a
    geometric distribution over the first ``hub_states`` columns."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    fail = rng.random(nnz) < p_fail
    # failure links: geometric over the shallow states (clipped)
    g = rng.geometric(p=8.0 / hub_states, size=nnz).astype(np.int64)
    hub = np.minimum(g - 1, hub_states - 1)
    fwd = rows + rng.integers(1, reach + 1, size=nnz)
    cols = np.where(fail, hub, np.minimum(fwd, n - 1))
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        vals=vals,
        shape=(n, n),
    ).sum_duplicates()


def road_usa_like(
    n: int = 1 << 23, deg: float = 2.5, reach: int = 64, seed: int = 17
) -> COOMatrix:
    """Stand-in for the road domain (road_usa-class: millions of rows,
    ~2.4 nnz/row, strong spatial locality under a good node ordering —
    paper Table 2).  Each row links to a few nearby rows."""
    rng = np.random.default_rng(seed)
    nnz = int(n * deg)
    rows = rng.integers(0, n, nnz).astype(np.int64)
    cols = np.clip(
        rows + rng.integers(-reach, reach + 1, nnz), 0, n - 1
    ).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, n),
    ).sum_duplicates()


def rgg_like(
    n: int = 1 << 21, deg: int = 6, reach: int = 96, seed: int = 19
) -> COOMatrix:
    """Stand-in for the routing domain (rgg-class random geometric
    graphs: ~6 nnz/row, edges between spatially close nodes — the domain
    where the reference reports its second-best numbers, 17.1 GFLOPS
    paper Table 3)."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(
        rows + rng.integers(-reach, reach + 1, nnz), 0, n - 1
    ).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, n),
    ).sum_duplicates()


def fem_like(
    n: int = 1 << 20, deg: int = 54, bw: int = 150, seed: int = 23
) -> COOMatrix:
    """Stand-in for the EngSci domain (FEM/engineering matrices: dense
    ~50-80 nnz rows within a narrow band after reordering — the
    reference's best domain, 21.1 GFLOPS paper Table 3)."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(
        rows + rng.integers(-bw, bw + 1, nnz), 0, n - 1
    ).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return COOMatrix(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        vals=vals, shape=(n, n),
    ).sum_duplicates()


# ---------------------------------------------------------------------------
# Second stand-ins per CGO'18 domain (round 4): different generator
# seeds AND parameters, so each domain's score is the min over >= 2
# structurally distinct matrices instead of one seed's luck (the paper's
# Table 3 averages several real matrices per domain).
# ---------------------------------------------------------------------------


def web_google_like_b() -> COOMatrix:
    """Web-graph second stand-in: shallower quadrant skew, lower edge
    factor, different seed (~4.6M nnz)."""
    return rmat_matrix(
        scale=20, edge_factor=5, a=0.59, b=0.18, c=0.18, seed=101
    )


def soc_livejournal_like_b() -> COOMatrix:
    """Social second stand-in: denser rows at half the vertex count."""
    return rmat_matrix(scale=21, edge_factor=12, seed=31)


def wiki_talk_like_b(seed: int = 99) -> COOMatrix:
    """Wiki second stand-in with an adversarial 100K-degree hub tail:
    the base steep R-MAT plus one ~100K-nnz row and one ~100K-reference
    column (wiki-Talk's celebrity structure, paper Table 2) — exercises
    split_len row-stealing and the hub-column machinery at once."""
    coo = rmat_matrix(
        scale=21, edge_factor=3, a=0.65, b=0.15, c=0.15, seed=seed
    )
    rng = np.random.default_rng(seed + 1)
    n = coo.shape[0]
    hub = 100_000
    hub_row = np.full(hub, 12345, dtype=np.int32)
    hub_row_cols = rng.integers(0, n, hub).astype(np.int32)
    hub_col_rows = rng.integers(0, n, hub).astype(np.int32)
    hub_col = np.full(hub, 54321, dtype=np.int32)
    rows = np.concatenate([coo.rows, hub_row, hub_col_rows])
    cols = np.concatenate([coo.cols, hub_row_cols, hub_col])
    vals = np.concatenate(
        [coo.vals, rng.standard_normal(2 * hub).astype(np.float32)]
    )
    return COOMatrix(
        rows=rows, cols=cols, vals=vals, shape=coo.shape
    ).sum_duplicates()


def citation_like_b() -> COOMatrix:
    """Citation second stand-in: milder skew, ~12 nnz/row."""
    return rmat_matrix(
        scale=20, edge_factor=12, a=0.52, b=0.22, c=0.22, seed=37
    )


def road_usa_like_b() -> COOMatrix:
    """Road second stand-in: half the vertices, denser, tighter reach."""
    return road_usa_like(n=1 << 22, deg=2.8, reach=48, seed=23)


def rgg_like_b() -> COOMatrix:
    """Routing second stand-in: smaller graph, denser, shorter reach."""
    return rgg_like(n=1 << 20, deg=9, reach=64, seed=5)


def fsm_like_b() -> COOMatrix:
    """FSM second stand-in: wider alphabet (deg 10), 4096 shallow hub
    states, lower failure fraction."""
    return fsm_like(
        n=1 << 20, deg=10, hub_states=4096, reach=32, p_fail=0.45,
        seed=29,
    )


def fem_like_b() -> COOMatrix:
    """EngSci second stand-in: denser rows, wider band, fewer nodes."""
    return fem_like(n=1 << 19, deg=80, bw=220, seed=3)


def banded_matrix(
    n: int, bandwidth: int = 27, seed: int = 0, dtype=np.float32
) -> COOMatrix:
    """A regular HPC-style banded matrix (the CVR paper's non-scale-free
    suite is dominated by such stencils, paper Table 2)."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(-(bandwidth // 2), bandwidth // 2 + 1)
    rows_list, cols_list = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off), dtype=np.int32)
        rows_list.append(r)
        cols_list.append(r + off)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list).astype(np.int32)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return COOMatrix(rows=rows, cols=cols, vals=vals, shape=(n, n))
