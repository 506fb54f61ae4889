"""ctypes bindings for the native C++ runtime (native/bf_native.cpp).

Builds on first use if the shared library is missing and a toolchain is
available; every entry point has a pure-Python fallback in io.event_file and
runtime.slice_buffer, so the framework works without a compiler.

Several processes may ask for the library at once (test workers, ranks).
The build runs under an exclusive lock on ``native/.libbf_native.lock``,
looks again for the library once it holds the lock, compiles into a
temporary directory beside it and moves the result onto
``libbf_native.so`` with ``os.replace``, so a reader finds no file or a
whole one.  A load that dlopen refuses (a file another process is still
writing in place) is retried and then rebuilt; a whole library that lacks
the newest entry point (a stale build) is rebuilt at once.  Only a failed
build is remembered.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import importlib.util
import os
import pathlib
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
LIB_NAME = "libbf_native.so"
LOCK_NAME = ".libbf_native.lock"
_SYMBOL = "bf_materialize_bandpad_u16"   # the newest entry point
_LOAD_TRIES = 50        # x 0.2 s: time for another process's build
_LOAD_WAIT_S = 0.2


class _EventArrays(ctypes.Structure):
    _fields_ = [
        ("t", ctypes.POINTER(ctypes.c_double)),
        ("x", ctypes.POINTER(ctypes.c_float)),
        ("y", ctypes.POINTER(ctypes.c_float)),
        ("p", ctypes.POINTER(ctypes.c_int8)),
        ("n", ctypes.c_int64),
    ]


@contextlib.contextmanager
def _build_lock(native_dir: pathlib.Path):
    """Exclusive lock of the native directory's builds, across processes."""
    with open(native_dir / LOCK_NAME, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(native_dir: pathlib.Path) -> pathlib.Path:
    """Compile ``native_dir/bf_native.cpp`` with ``native_dir/build.py``
    into a temporary directory there, then move the library onto its final
    name.  Raises when the toolchain fails.  Call under ``_build_lock``."""
    spec = importlib.util.spec_from_file_location(
        "_bf_native_build", native_dir / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tmp = tempfile.mkdtemp(prefix=".build-", dir=native_dir)
    try:
        out = pathlib.Path(mod.build(tmp))
        final = native_dir / LIB_NAME
        os.replace(out, final)
        return final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dlopen(so: pathlib.Path) -> Optional[ctypes.CDLL]:
    """The library at ``so``, or None when dlopen refuses it."""
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        return None


def _load(so: pathlib.Path) -> Optional[ctypes.CDLL]:
    """The library at ``so`` if it loads and is current, else None."""
    lib = _dlopen(so)
    return lib if lib is not None and hasattr(lib, _SYMBOL) else None


def _load_fresh(so: pathlib.Path) -> Optional[ctypes.CDLL]:
    """Load a private copy of ``so``: dlopen caches by path within a
    process, so a stale library loaded once under ``so`` would be returned
    again."""
    tmp = tempfile.mkdtemp(prefix=".load-", dir=so.parent)
    try:
        copy = pathlib.Path(tmp) / so.name
        shutil.copy(so, copy)
        return _load(copy)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _find_or_build(native_dir: Optional[pathlib.Path] = None
                   ) -> Optional[ctypes.CDLL]:
    """Load ``native_dir/libbf_native.so`` (the repository's ``native/`` by
    default), building it first when it is missing, and rebuilding it when
    it stays unloadable or is stale.  Raises when a build fails."""
    d = pathlib.Path(native_dir) if native_dir is not None else NATIVE_DIR
    so = d / LIB_NAME
    with _build_lock(d):
        if not so.exists():
            _build(d)
    lib = None
    for _ in range(_LOAD_TRIES):
        lib = _dlopen(so)
        if lib is not None or not so.exists():
            break
        time.sleep(_LOAD_WAIT_S)
    if lib is None or not hasattr(lib, _SYMBOL):
        with _build_lock(d):
            _build(d)
            lib = _load_fresh(so)
        if lib is None:
            return None
    lib.bf_parse_events.restype = ctypes.c_int64
    lib.bf_parse_events.argtypes = [ctypes.c_char_p, ctypes.POINTER(_EventArrays)]
    lib.bf_free_events.argtypes = [ctypes.POINTER(_EventArrays)]
    lib.bf_write_events_uv.restype = ctypes.c_int64
    lib.bf_write_events_uv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.bf_materialize_bandpad.restype = ctypes.c_int64
    lib.bf_materialize_bandpad.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,  # S
        ctypes.c_int64,  # capp
        ctypes.c_int64,  # band_rows
        ctypes.c_int64,  # chunk
        ctypes.c_int64,  # n_bands
        ctypes.c_int64,  # res_y
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint16),
    ]
    lib.bf_materialize_bandpad_u16.restype = ctypes.c_int64
    lib.bf_materialize_bandpad_u16.argtypes = (
        [ctypes.POINTER(ctypes.c_uint16)] * 2
        + [ctypes.POINTER(ctypes.c_int64)] * 4
        + [ctypes.c_int64] * 6
        + [ctypes.POINTER(ctypes.c_uint16)] * 2
        + [ctypes.POINTER(ctypes.c_float),
           ctypes.POINTER(ctypes.c_uint16),
           ctypes.POINTER(ctypes.c_int32)]
    )
    lib.bf_coords_u16_f64.restype = ctypes.c_int64
    lib.bf_coords_u16_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
    ]
    lib.bf_coords_u16_f32.restype = ctypes.c_int64
    lib.bf_coords_u16_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
    ]
    return lib


def materialize_bandpad(x, y, t_ns, starts, ends, slice_start_ns,
                        capp: int, band_rows: int, chunk: int,
                        n_bands: int, res_y: int):
    """Native band-padded compact slice materialization (the layout of
    runtime/scan_pipeline.materialize_slices(band_pad=True) + u16 compact
    encoding).  Returns (xs16, ys16, ts, perm) or None if the native
    library is unavailable or a slice exceeds ``capp``."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    slice_start_ns = np.ascontiguousarray(slice_start_ns, np.int64)
    S = len(starts)
    xs16 = np.empty((S, capp), np.uint16)
    ys16 = np.empty((S, capp), np.uint16)
    ts = np.empty((S, capp), np.float32)
    perm = np.empty((S, capp), np.uint16)

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    rc = lib.bf_materialize_bandpad(
        p(x, ctypes.c_float), p(y, ctypes.c_float), p(t_ns, ctypes.c_int64),
        p(starts, ctypes.c_int64), p(ends, ctypes.c_int64),
        p(slice_start_ns, ctypes.c_int64),
        S, capp, band_rows, chunk, n_bands, res_y,
        p(xs16, ctypes.c_uint16), p(ys16, ctypes.c_uint16),
        p(ts, ctypes.c_float), p(perm, ctypes.c_uint16),
    )
    if rc != 0:
        return None
    return xs16, ys16, ts, perm


def coords_u16(x, y):
    """One-pass coordinate narrowing + validity check in C++ (f64 or f32
    input, no intermediate f32 copy).  Returns (x16, y16) u16 arrays, or
    None if the native library is missing or any coordinate is negative,
    non-integral, or >= 0xFFFF (callers then take the generic path)."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)
    if x.dtype == np.float64 and y.dtype == np.float64:
        fn, ct = lib.bf_coords_u16_f64, ctypes.c_double
    elif x.dtype == np.float32 and y.dtype == np.float32:
        fn, ct = lib.bf_coords_u16_f32, ctypes.c_float
    else:
        x = np.ascontiguousarray(x, np.float64)
        y = np.ascontiguousarray(y, np.float64)
        fn, ct = lib.bf_coords_u16_f64, ctypes.c_double
    n = len(x)
    xo = np.empty(n, np.uint16)
    yo = np.empty(n, np.uint16)

    def p(a, c):
        return a.ctypes.data_as(ctypes.POINTER(c))

    rc = fn(p(x, ct), p(y, ct), n,
            p(xo, ctypes.c_uint16), p(yo, ctypes.c_uint16))
    if rc != 0:
        return None
    return xo, yo


def materialize_bandpad_u16(x16, y16, t_ns, starts, ends, slice_start_ns,
                            capp: int, band_rows: int, chunk: int,
                            n_bands: int, res_y: int):
    """u16-coordinate materialization with per-slice bbox: the zero-copy
    staging path (coords_u16 output feeds straight in).  Returns
    (xs16, ys16, ts, perm, bbox[S, 4]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    x16 = np.ascontiguousarray(x16, np.uint16)
    y16 = np.ascontiguousarray(y16, np.uint16)
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    slice_start_ns = np.ascontiguousarray(slice_start_ns, np.int64)
    S = len(starts)
    xs16 = np.empty((S, capp), np.uint16)
    ys16 = np.empty((S, capp), np.uint16)
    ts = np.empty((S, capp), np.float32)
    perm = np.empty((S, capp), np.uint16)
    bbox = np.zeros((S, 4), np.int32)

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    rc = lib.bf_materialize_bandpad_u16(
        p(x16, ctypes.c_uint16), p(y16, ctypes.c_uint16),
        p(t_ns, ctypes.c_int64),
        p(starts, ctypes.c_int64), p(ends, ctypes.c_int64),
        p(slice_start_ns, ctypes.c_int64),
        S, capp, band_rows, chunk, n_bands, res_y,
        p(xs16, ctypes.c_uint16), p(ys16, ctypes.c_uint16),
        p(ts, ctypes.c_float), p(perm, ctypes.c_uint16),
        p(bbox, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return xs16, ys16, ts, perm, bbox


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None when it cannot be built here (that
    outcome is remembered for the process)."""
    global _LIB, _TRIED
    if not _TRIED:
        try:
            _LIB = _find_or_build()
        except Exception:
            _LIB = None
        _TRIED = True
    return _LIB


def parse_events(path: str) -> Optional[dict]:
    """Fast native parse of a 't x y p' recording; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = _EventArrays()
    n = lib.bf_parse_events(str(path).encode(), ctypes.byref(arrs))
    if n < 0:
        raise FileNotFoundError(path)
    try:
        t = np.ctypeslib.as_array(arrs.t, (n,)).copy()
        x = np.ctypeslib.as_array(arrs.x, (n,)).copy()
        y = np.ctypeslib.as_array(arrs.y, (n,)).copy()
        p = np.ctypeslib.as_array(arrs.p, (n,)).copy()
    finally:
        lib.bf_free_events(ctypes.byref(arrs))
    return {
        "x": x.astype(np.float64),
        "y": y.astype(np.float64),
        "t_ns": (1e9 * t).astype(np.int64),
        "polarity": p,
    }


def write_events_uv(path: str, x, y, t_ns, u, v, maxt: float = 0.0) -> Optional[int]:
    """Fast native writer; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    t_s = np.ascontiguousarray(np.asarray(t_ns, np.float64) / 1e9 + maxt)
    xf = np.ascontiguousarray(x, np.float32)
    yf = np.ascontiguousarray(y, np.float32)
    uf = np.ascontiguousarray(u, np.float32)
    vf = np.ascontiguousarray(v, np.float32)
    n = lib.bf_write_events_uv(
        str(path).encode(),
        t_s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        xf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        yf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        uf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(xf),
    )
    return int(n) if n >= 0 else None
