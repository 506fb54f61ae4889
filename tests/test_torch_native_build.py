"""The port's native loader builds ``libbf_native.so`` atomically under a
lock: processes that ask for it at once each load a whole library.

``better_flow_tpu_torch.io.native`` compiles into a temporary directory and
moves the result onto the final name under an exclusive ``flock``, looking
again for the library once it holds the lock, so no process loads a
half-written file, a failed load is retried rather than remembered, and a
stale library is rebuilt at once.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch.io import native  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHILD = """
import sys
from better_flow_tpu_torch.io import native
lib = native._find_or_build(sys.argv[1])
ok = lib is not None and hasattr(lib, "bf_materialize_bandpad_u16")
print("LOADED" if ok else "FAILED")
"""


def _empty_native_copy(tmp_path) -> pathlib.Path:
    d = tmp_path / "native"
    d.mkdir()
    for name in ("bf_native.cpp", "build.py"):
        shutil.copy(REPO / "native" / name, d / name)
    return d


def test_two_processes_build_and_load_one_whole_library(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain: the native library cannot be built")
    d = _empty_native_copy(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip().splitlines()[-1] == "LOADED", (out, err)
    # One library, no temporary build left behind, the lock file kept.
    left = sorted(p.name for p in d.iterdir())
    assert left == sorted(["bf_native.cpp", "build.py", native.LIB_NAME,
                           native.LOCK_NAME]), left


def test_unloadable_library_is_rebuilt_not_remembered(tmp_path, monkeypatch):
    """A truncated file at the final path (what a reader of an in-place
    build sees) is waited for, then rebuilt; the process then loads."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain: the native library cannot be built")
    d = _empty_native_copy(tmp_path)
    (d / native.LIB_NAME).write_bytes(b"\x7fELF")
    monkeypatch.setattr(native, "_LOAD_TRIES", 2)
    monkeypatch.setattr(native, "_LOAD_WAIT_S", 0.01)
    lib = native._find_or_build(d)
    assert lib is not None and hasattr(lib, "bf_materialize_bandpad_u16")
    assert native._load(d / native.LIB_NAME) is not None


def test_stale_library_is_rebuilt_without_waiting(tmp_path, monkeypatch):
    """A whole library that lacks the newest entry point (an older build)
    is rebuilt under the lock at once: only a file dlopen refuses is
    waited for."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain: the native library cannot be built")
    d = _empty_native_copy(tmp_path)
    src = tmp_path / "old.cpp"
    src.write_text('extern "C" int bf_parse_events() { return 0; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(d / native.LIB_NAME),
                    str(src)], check=True)
    assert native._dlopen(d / native.LIB_NAME) is not None
    assert native._load(d / native.LIB_NAME) is None

    def no_wait(_):
        raise AssertionError("waited for a whole, stale library")

    monkeypatch.setattr(native.time, "sleep", no_wait)
    lib = native._find_or_build(d)
    assert lib is not None and hasattr(lib, "bf_materialize_bandpad_u16")
