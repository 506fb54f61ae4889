"""Build and load the CUDA kernels of ``csrc/``.

At first use ``library()`` compiles every ``csrc/*.cu`` with its own nvcc
process, all started together, and links the objects into one shared
library with a plain C interface, under ``better_flow_tpu_torch/_build/``,
named by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The library is loaded
with ctypes; each entry point takes device pointers, sizes and a CUDA
stream (``bf_trip``: a launch plan holding them, ``TripArgs``) and returns
its CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# --fmad=false: the warp and the Kahan model update must round after every
# multiply and add, as the f32 reference does.  No fast-math: IEEE division
# and the accurate cos/sin.  The grid-wide barrier of iteration.cuh (B2,
# B5, B6, B7b, B9, B10/B11, B12: cooperative_groups grid.sync()) needs no
# -rdc=true since CUDA 11; it needs only the cooperative launch that their
# entry points make.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
]

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


class UpdateParams(ctypes.Structure):
    """Mirror of ``bf::UpdateParams`` in csrc/finish.cuh."""

    _fields_ = [
        ("fast", ctypes.c_int),
        ("use_grad", ctypes.c_int),
        ("use_pred", ctypes.c_int),
        ("max_iter", ctypes.c_int),
        ("hard_cap", ctypes.c_int),
        ("tol", ctypes.c_float * 4),
        ("tol4", ctypes.c_float * 4),
        ("grad_tol", ctypes.c_float * 4),
        ("pred_tol", ctypes.c_float * 4),
        ("xy_cap", ctypes.c_float),
        ("rotdiv_cap", ctypes.c_float),
    ]


class TripArgs(ctypes.Structure):
    """Mirror of ``TripArgs`` in csrc/trip.cu: a planned trip's launch
    arguments (``ops.fused_model.TripPlan``)."""

    _fields_ = [
        ("geo", ctypes.c_void_p),
        ("stat", ctypes.c_void_p),
        ("act", ctypes.c_void_p),
        ("pr0", ctypes.c_void_p),
        ("st0", ctypes.c_void_p),
        ("acc_t", ctypes.c_void_p),
        ("acc_c", ctypes.c_void_p),
        ("pr", ctypes.c_void_p * 2),
        ("st", ctypes.c_void_p * 2),
        ("partials", ctypes.c_void_p),
        ("slot", ctypes.c_void_p),
        ("event", ctypes.c_void_p),
        ("stream", ctypes.c_void_p),
        ("nch", ctypes.c_int),
        ("HP", ctypes.c_int),
        ("WP", ctypes.c_int),
        ("H", ctypes.c_int),
        ("W", ctypes.c_int),
        ("scale", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("smem", ctypes.c_int),
        ("time_lo", ctypes.c_int),
        ("unroll", ctypes.c_int),
        ("predicated", ctypes.c_int),
        ("params", UpdateParams),
    ]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(extra_flags) -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return h.hexdigest()[:16]


def build(extra_flags=()) -> pathlib.Path:
    """Compile the sources unless a library of the same hash exists: one
    nvcc per source in parallel, then one link.  Returns its path;
    ``BUILD_INFO`` records the time and nvcc's output."""
    out = BUILD_DIR / f"libbf_kernels_{_digest(extra_flags)}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-c",
                 "-o", o, str(p)] for p, o in zip(cu, objs)]
        cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o",
                     os.path.join(tmp, "lib.so"), *objs])
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds[:-1]]
        log = []
        for cmd, proc in zip(cmds, procs):
            o, e = proc.communicate()
            log.append(o + e)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{o}\n{e}")
        proc = subprocess.run(cmds[-1], capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmds[-1])}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(os.path.join(tmp, "lib.so"), out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log="".join(log))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bf_act_rows.argtypes = [P, P, I, I, I, P, P]
        lib.bf_warp_images_st.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.bf_megastep_finish.argtypes = [P] * 6 + [I] * 8 + [
            ctypes.POINTER(UpdateParams), P]
        lib.bf_warp_uv.argtypes = [P, P, P, P, F, P, P, I, P, P, P, F, F,
                                     I, P]
        lib.bf_megastep.argtypes = [P] * 10 + [I] * 9 + [
            ctypes.POINTER(UpdateParams), I, P]
        lib.bf_megastep2.argtypes = lib.bf_megastep.argtypes
        lib.bf_fused_warp_splat.argtypes = [P] * 9 + [I] * 8 + [P]
        lib.bf_warp_splat_images.argtypes = [P] * 7 + [I] * 4 + [P]
        lib.bf_finish_partials.argtypes = [P] * 4 + [I] * 7 + [P]
        lib.bf_splat_local.argtypes = [P] * 5 + [I] * 7 + [P]
        lib.bf_finish_local.argtypes = [P] * 4 + [I] * 12 + [P]
        lib.bf_fused_model_partials.argtypes = [P] * 9 + [I] * 8 + [P]
        lib.bf_fused_model_partials_windowed.argtypes = \
            lib.bf_fused_model_partials.argtypes
        lib.bf_trip.argtypes = [ctypes.POINTER(TripArgs), I]
        lib.bf_trip_wait.argtypes = [ctypes.POINTER(TripArgs)]
        lib.bf_trip_event.argtypes = [ctypes.POINTER(P)]
        grids = [getattr(lib, f"bf_{k}_grid") for k in (
            "megastep", "fused_warp_splat", "finish_partials",
            "megastep_finish", "megastep2", "finish_local",
            "fused_model_partials")]
        for fn in grids:
            fn.argtypes = [I]
        lib.bf_splat_local_grid.argtypes = [I, I]
        grids.append(lib.bf_splat_local_grid)
        for fn in [lib.bf_act_rows, lib.bf_warp_images_st,
                   lib.bf_megastep_finish, lib.bf_warp_uv, lib.bf_megastep,
                   lib.bf_fused_warp_splat, lib.bf_warp_splat_images,
                   lib.bf_finish_partials, lib.bf_splat_local,
                   lib.bf_finish_local, lib.bf_fused_model_partials,
                   lib.bf_fused_model_partials_windowed,
                   lib.bf_megastep2, lib.bf_trip, lib.bf_trip_wait,
                   lib.bf_trip_event] + grids:
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
