"""ctypes bindings for the native host runtime (native/libcvr_native.so).

Provides the fast paths for MatrixMarket parsing, COO->CSR assembly and
the SELL-pack converter; every caller has a pure-NumPy fallback, so the
package works without the compiled library (``CVR_TPU_NO_NATIVE=1``
disables it explicitly).  The library is built with ``make -C native``
on first use, and rebuilt whenever the hash of the source and Makefile
differs from the stamp written beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
build_error = ""  # why the last build failed, for reports

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SO_PATH = _REPO_ROOT / "native" / "libcvr_native.so"
_STAMP_PATH = _SO_PATH.with_suffix(".stamp")

FIELD_NAMES = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
SYM_NAMES = {0: "general", 1: "symmetric", 2: "skew-symmetric", 3: "hermitian"}

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def source_hash(native_dir: Path | None = None) -> str:
    """sha256 of the native source and Makefile: the build's identity."""
    d = native_dir or _SO_PATH.parent
    h = hashlib.sha256()
    for name in ("cvr_native.cpp", "Makefile"):
        h.update((d / name).read_bytes())
    return h.hexdigest()


def _build_if_needed(so_path: Path | None = None) -> bool:
    """Build the library unless one stamped with this source's hash exists.

    A library built from other source (or copied in from another host)
    is rebuilt.  The build writes a private file and renames it into
    place, so concurrent processes never load a half-written library.
    """
    so_path = so_path or _SO_PATH
    stamp = so_path.with_suffix(".stamp")
    want = source_hash(so_path.parent)
    if so_path.exists() and stamp.exists() and stamp.read_text() == want:
        return True
    global build_error
    tmp = f"{so_path.name}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-B", "-C", str(so_path.parent), f"TARGET={tmp}"],
            check=True,
            capture_output=True,
            text=True,
            timeout=300,
        )
    except subprocess.CalledProcessError as e:
        build_error = (e.stdout + e.stderr)[-2000:]
        return False
    except (OSError, subprocess.SubprocessError) as e:
        build_error = repr(e)
        return False
    os.replace(so_path.parent / tmp, so_path)
    stamp_tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}.tmp")
    stamp_tmp.write_text(want)
    os.replace(stamp_tmp, stamp)
    return True


def get_lib():
    """The loaded native library, or None if unavailable/disabled."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CVR_TPU_NO_NATIVE"):
        return None
    if not _build_if_needed():
        return None
    global build_error
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError as e:
        build_error = repr(e)
        return None

    lib.cvr_last_error.restype = ctypes.c_char_p
    lib.cvr_version.restype = ctypes.c_int
    lib.cvr_version.argtypes = []
    lib.cvr_omp_threads.restype = ctypes.c_int
    lib.cvr_omp_threads.argtypes = []
    lib.cvr_mtx_open.restype = ctypes.c_int
    lib.cvr_mtx_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(_i64),
        ctypes.POINTER(_i64),
        ctypes.POINTER(_i64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cvr_mtx_read.restype = ctypes.c_int
    lib.cvr_mtx_read.argtypes = [ctypes.c_int, _i32p, _i32p, _f32p, ctypes.c_int]
    lib.cvr_mtx_close.restype = ctypes.c_int
    lib.cvr_mtx_close.argtypes = [ctypes.c_int]
    lib.cvr_coo_to_csr.restype = ctypes.c_int
    lib.cvr_coo_to_csr.argtypes = [
        _i64, _i64, _i32p, _i32p, _f32p, _i64p, _i32p, _f32p,
    ]
    lib.cvr_sell_count_segments.restype = _i64
    lib.cvr_sell_count_segments.argtypes = [_i64, _i64p, _i64]
    lib.cvr_sell_plan.restype = ctypes.c_int
    lib.cvr_sell_plan.argtypes = [
        _i64, _i64p, _i64, _i64, _i32p, _i32p, _i32p, _i64p,
    ]
    lib.cvr_sell_fill.restype = ctypes.c_int
    lib.cvr_sell_fill.argtypes = [
        _i64, _i64, _i64p, _i32p, _f32p, _i32p, _i32p, _i32p, _i64p,
        _i32p, _f32p, _i32p,
    ]
    _i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.cvr_bsr_count.restype = _i64
    lib.cvr_bsr_count.argtypes = [_i64, _i64, _i64p, _i32p]
    lib.cvr_bsr_fill.restype = ctypes.c_int
    lib.cvr_bsr_fill.argtypes = [
        _i64, _i64, _i64p, _i32p, _f32p, _i64, _i32p, _i32p, _f32p,
    ]
    _i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    _u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.cvr_dia_offsets.restype = ctypes.c_int
    lib.cvr_dia_offsets.argtypes = [_i64, _i64, _i64p, _i32p, _u8p]
    lib.cvr_dia_fill.restype = ctypes.c_int
    lib.cvr_dia_fill.argtypes = [
        _i64, _i64, _i64p, _i32p, _f32p, _i64, _i64p, _f32p,
    ]
    lib.cvr_bell_stats.restype = ctypes.c_int64
    lib.cvr_bell_stats.argtypes = [_i64, _i64p, _i32p, _i64, _i32p]
    lib.cvr_bell_fill.restype = ctypes.c_int64
    lib.cvr_bell_fill.argtypes = [
        _i64, _i64p, _i32p, _f32p, _i64, _i64, _i64, _i64,
        _i16p, _f32p, _i64, _i32p, _i32p, _f32p,
    ]
    if lib.cvr_version() != 18:
        build_error = f"library version {lib.cvr_version()}, expected 18"
        return None
    _LIB = lib
    return _LIB


def native_error(lib) -> str:
    return lib.cvr_last_error().decode()


class NativeError(RuntimeError):
    pass


def mtx_read_native(path: str | os.PathLike, pattern_mode: int = 0):
    """Parse a coordinate .mtx with the native parser.

    Returns (rows, cols, vals, nrows, ncols, field, symmetry) with raw
    (un-mirrored) entries, 0-based.  Raises NativeError when the native
    path can't handle the file (caller falls back to the Python parser).
    """
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    nrows = _i64()
    ncols = _i64()
    nnz = _i64()
    field = ctypes.c_int()
    sym = ctypes.c_int()
    h = lib.cvr_mtx_open(
        str(path).encode(),
        ctypes.byref(nrows),
        ctypes.byref(ncols),
        ctypes.byref(nnz),
        ctypes.byref(field),
        ctypes.byref(sym),
    )
    if h < 0:
        raise NativeError(native_error(lib))
    try:
        rows = np.empty(nnz.value, dtype=np.int32)
        cols = np.empty(nnz.value, dtype=np.int32)
        vals = np.empty(nnz.value, dtype=np.float32)
        if lib.cvr_mtx_read(h, rows, cols, vals, pattern_mode) != 0:
            raise NativeError(native_error(lib))
    finally:
        lib.cvr_mtx_close(h)
    return (
        rows,
        cols,
        vals,
        int(nrows.value),
        int(ncols.value),
        FIELD_NAMES[field.value],
        SYM_NAMES[sym.value],
    )


def coo_to_csr_native(nrows: int, rows, cols, vals):
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nnz = rows.shape[0]
    rowptr = np.empty(nrows + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float32)
    if lib.cvr_coo_to_csr(
        nrows, nnz, rows, cols, vals, rowptr, out_cols, out_vals
    ) != 0:
        raise NativeError(native_error(lib))
    return rowptr, out_cols, out_vals


def sell_pack_native(rowptr, csr_cols, csr_vals, C: int, split_len: int):
    """Native CSR -> SELL-pack.  Returns the same arrays sell_pack builds.

    (Sorting is a counting sort on segment length — O(G + maxlen), exactly
    stable like np.argsort(kind='stable').)
    """
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    csr_cols = np.ascontiguousarray(csr_cols, dtype=np.int32)
    csr_vals = np.ascontiguousarray(csr_vals, dtype=np.float32)
    nrows = rowptr.shape[0] - 1

    G = int(lib.cvr_sell_count_segments(nrows, rowptr, split_len))
    seg_row = np.empty(G, dtype=np.int32)
    seg_off = np.empty(G, dtype=np.int32)
    sorted_len = np.empty(G, dtype=np.int32)
    order = np.empty(G, dtype=np.int64)
    if lib.cvr_sell_plan(
        nrows, rowptr, split_len, G, seg_row, seg_off, sorted_len, order
    ) != 0:
        raise NativeError(native_error(lib))

    nslices = max(1, -(-G // C))
    P = nslices * C
    pad_sorted_len = np.zeros(P, dtype=np.int32)
    pad_sorted_len[:G] = sorted_len
    widths = pad_sorted_len.reshape(nslices, C).max(axis=1)
    slice_offsets = np.zeros(nslices + 1, dtype=np.int32)
    np.cumsum(widths, out=slice_offsets[1:])
    S = int(slice_offsets[-1])

    vals_plane = np.zeros((S, C), dtype=np.float32)
    cols_plane = np.zeros((S, C), dtype=np.int32)
    if lib.cvr_sell_fill(
        G,
        C,
        rowptr,
        csr_cols,
        csr_vals,
        seg_row,
        seg_off,
        sorted_len,
        order,
        slice_offsets,
        vals_plane,
        cols_plane,
    ) != 0:
        raise NativeError(native_error(lib))

    perm = np.full(P, nrows, dtype=np.int32)
    perm[:G] = seg_row[order]
    seg_offset = np.zeros(P, dtype=np.int32)
    seg_offset[:G] = seg_off[order]
    lane_lengths = pad_sorted_len
    slot_slice = np.repeat(np.arange(nslices, dtype=np.int32), widths)
    n_splits = G - nrows
    return (
        vals_plane,
        cols_plane,
        slice_offsets,
        slot_slice,
        perm,
        seg_offset,
        lane_lengths,
        n_splits,
    )


def bsr_count_native(nrows, ncb, rowptr, csr_cols) -> int:
    """Occupied 128x128 brick count (BSR pass 1)."""
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    return int(
        lib.cvr_bsr_count(
            nrows, ncb,
            np.ascontiguousarray(rowptr, dtype=np.int64),
            np.ascontiguousarray(csr_cols, dtype=np.int32),
        )
    )


def bsr_fill_native(nrows, ncb, rowptr, csr_cols, csr_vals, nbricks):
    """Brick coordinates + dense value planes (BSR pass 2)."""
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    brick_row = np.empty(nbricks, dtype=np.int32)
    brick_col = np.empty(nbricks, dtype=np.int32)
    bvals = np.zeros((nbricks, 128, 128), dtype=np.float32)
    rc = lib.cvr_bsr_fill(
        nrows, ncb,
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(csr_cols, dtype=np.int32),
        np.ascontiguousarray(csr_vals, dtype=np.float32),
        nbricks, brick_row, brick_col, bvals,
    )
    if rc != 0:
        raise NativeError(native_error(lib))
    return brick_row, brick_col, bvals


def dia_offsets_native(rowptr, cols, nrows: int, ncols: int):
    """Distinct diagonals (col - row) in one native pass."""
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    flags = np.zeros(nrows + ncols, dtype=np.uint8)
    rc = lib.cvr_dia_offsets(
        nrows, int(rowptr[-1]),
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
        flags,
    )
    if rc != 0:
        raise NativeError(native_error(lib))
    return np.flatnonzero(flags).astype(np.int64) - nrows


def dia_fill_native(rowptr, cols, vals, offsets, nrows: int):
    """DIA band planes in one native pass (formats/dia.py)."""
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    bands = np.zeros((offsets.shape[0], nrows), dtype=np.float32)
    rc = lib.cvr_dia_fill(
        nrows, int(rowptr[-1]),
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals, dtype=np.float32),
        offsets.shape[0], offsets, bands,
    )
    if rc != 0:
        raise NativeError(native_error(lib))
    return bands


def available() -> bool:
    return get_lib() is not None


def omp_threads() -> int | None:
    """Threads of the native converter: 0 when the library was built
    without OpenMP (serial), None when there is no native library."""
    lib = get_lib()
    return None if lib is None else int(lib.cvr_omp_threads())


def bell_stats_native(rowptr, cols, cap: int):
    """Per-row near-entry counts + the achieved reach (max near |off|)."""
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nrows = rowptr.shape[0] - 1
    near_lens = np.empty(nrows, dtype=np.int32)
    reach = int(lib.cvr_bell_stats(nrows, rowptr, cols, cap, near_lens))
    return near_lens, reach


def bell_fill_native(
    rowptr, cols, vals, k: int, cap: int, cr: int, R128: int,
    spill_cap: int,
):
    """Fill BELL (li, val) planes + compact spill COO in one pass.

    Returns (li (k, R128) int16, vals (k, R128) f32, spill_rows,
    spill_cols, spill_vals) with the spill arrays trimmed to the count.
    """
    lib = get_lib()
    if lib is None:
        raise NativeError("native library unavailable")
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nrows = rowptr.shape[0] - 1
    li = np.zeros((k, R128), dtype=np.int16)
    vout = np.zeros((k, R128), dtype=np.float32)
    sr = np.empty(spill_cap, dtype=np.int32)
    sc = np.empty(spill_cap, dtype=np.int32)
    sv = np.empty(spill_cap, dtype=np.float32)
    ns = int(
        lib.cvr_bell_fill(
            nrows, rowptr, cols, vals, k, cap, cr, R128, li, vout,
            spill_cap, sr, sc, sv,
        )
    )
    if ns < 0:
        raise NativeError("bell_fill: spill capacity exceeded")
    return li, vout, sr[:ns], sc[:ns], sv[:ns]
