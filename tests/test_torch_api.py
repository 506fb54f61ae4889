"""The JAX package's call forms on the PyTorch port.

Each ``__init__``'s ``__all__`` against the JAX package's, read from its
source by ``ast`` (no import of the JAX package needed); importing a
subpackage builds no kernel; the warp API's ``nz=`` keyword (bitwise the
fixed-NZ arithmetic at its default, bitwise the jitted JAX functions at
other values); ``local_flow_window`` bitwise the jitted JAX function on
``tests/test_local_flow.py``'s windows; ``LocalState``; ``MotionModel.
pretty`` the JAX string; ``jit_event_parallel``'s parameters."""

import ast
import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu.ops import warp as jwarp  # noqa: E402
import better_flow_tpu_torch  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.models import local_flow as tlf  # noqa: E402
from better_flow_tpu_torch.ops import warp as twarp  # noqa: E402
from better_flow_tpu_torch.parallel import event_parallel as tep  # noqa: E402

jlf = importlib.import_module("better_flow_tpu.models.local_flow")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("", "core", "models", "ops", "runtime", "parallel", "io",
               "viz", "eval")
# The port's own entry points beside the JAX package's top-level names.
TOP_LEVEL_EXTRAS = {"DVSFlow", "compensate_recording",
                    "compensate_recording_scan", "prepare_recording"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_all(sub: str):
    path = os.path.join(ROOT, "better_flow_tpu", sub, "__init__.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"no __all__ in {path}")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_matches_the_jax_package(sub):
    """Every subpackage exports the JAX package's names, in its order, and
    each resolves; the top level adds only the port's entry points."""
    name = "better_flow_tpu_torch" + ("." + sub if sub else "")
    mod = importlib.import_module(name)
    want = _jax_all(sub)
    got = list(mod.__all__)
    if sub:
        assert got == want
    else:
        assert got[:len(want)] == want
        assert set(got[len(want):]) == TOP_LEVEL_EXTRAS
    for n in got:
        assert getattr(mod, n) is not None, n


def test_top_level_names_are_the_configs():
    from better_flow_tpu_torch import config

    for n in ("NZ", "T_DIVIDER", "UV_FACTOR", "SensorConfig", "SliceConfig",
              "OptimizerConfig", "PipelineConfig"):
        assert getattr(better_flow_tpu_torch, n) is getattr(config, n)
    assert better_flow_tpu_torch.__version__ == "0.1.0"


def test_importing_a_subpackage_builds_no_kernel():
    """In a fresh process: ``import *`` of every subpackage leaves the
    kernel library unbuilt and imports nothing of JAX."""
    code = (
        "import sys\n"
        + "".join(f"from better_flow_tpu_torch{'.' + s if s else ''} "
                  "import *\n" for s in SUBPACKAGES)
        + "from better_flow_tpu_torch.ops import _build\n"
        "assert _build._LIB is None and not _build.BUILD_INFO\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'better_flow_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ the warp's nz


def _warp_inputs():
    rng = np.random.default_rng(0)
    n = 5000
    fx, fy = (rng.uniform(0, 240, n).astype(np.float32) for _ in range(2))
    t = rng.uniform(0, 2e8, n).astype(np.float32)
    px, py, nx, ny = (rng.normal(0, 3, n).astype(np.float32)
                      for _ in range(4))
    sc = [np.float32(v) for v in (0.3, -0.2, 90.0, 120.0, 0.01, 0.02)]
    return {
        "apply_project": (fx, fy, t, nx, ny),
        "project_dn": (fx, fy, t, nx, ny, np.float32(0.1),
                       np.float32(-0.2)),
        "project_divcrl": (fx, fy, t, px, py, nx, ny, *sc[2:]),
        "project_4param": (fx, fy, t, px, py, nx, ny, *sc),
        "project_4param_reinit": (fx, fy, t, px, py, *sc),
        "compute_uv": (nx, ny),
        "n_from_u": (nx,),
    }


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


@pytest.mark.parametrize("name", list(_warp_inputs()))
def test_warp_nz_keyword(name):
    """``nz=`` at its default and at 127 is bitwise the call without it;
    at 64 and 255.5 bitwise the JAX function as XLA compiles it."""
    args = _warp_inputs()[name]
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    fn = getattr(twarp, name)
    assert inspect.signature(fn).parameters["nz"].default == 127.0
    plain = _tuple(fn(*targs))
    for got in (_tuple(fn(*targs, nz=127.0)), _tuple(fn(*targs, nz=127))):
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    for nz in (64.0, 255.5):
        want = _tuple(jax.jit(lambda *z: getattr(jwarp, name)(*z, nz=nz))(
            *[jnp.asarray(a) for a in args]))
        got = _tuple(fn(*targs, nz=nz))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not torch.equal(got[0], plain[0])


# ------------------------------------------------- one window's descent


CENTRES = ([24.0, 20.0, 30.0, 17.5], [24.0, 30.0, 18.0, 26.25])


def _windows(k=6144):
    """``tests/test_local_flow.py``'s translating 48x48 scene, gathered
    around four centres by both packages."""
    d = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=48,
                         vx=90.0, vy=-60.0, n_points=60, seed=3,
                         margin=0.25)
    x, y, t = d["x"], d["y"], d["t_ns"].astype(np.float64)
    valid = np.ones(len(x), bool)
    return (jlf.gather_windows(x, y, t, valid, *CENTRES, wsz=31, k=k),
            tlf.gather_windows(x, y, t, valid, *CENTRES, wsz=31, k=k,
                               device="cpu"))


@pytest.mark.parametrize("kw", [dict(), dict(nx0=0.5, ny0=-0.25, dn0=0.02),
                                dict(max_iters=5)])
def test_local_flow_window_is_the_jax_functions(kw):
    jw, tw = _windows()
    jfn = jax.jit(jlf.local_flow_window,
                  static_argnames=("scale", "wsz", "max_time_ms",
                                   "max_iters", "dn0"))
    for g in range(len(CENTRES[0])):
        jone = jlf.LocalWindow(*(f[g] for f in jw))
        tone = tlf.LocalWindow(*(f[g] for f in tw))
        want = jfn(jone, scale=3, wsz=31, **kw)
        got = tlf.local_flow_window(tone, 3, 31, **kw)
        assert all(v.dim() == 0 for v in got)
        assert int(got[2]) == int(want[2]) > 0
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if not kw:
        # The window's descent is the one local_flow_field runs for it.
        _u, _v, _n, iters, nx, ny = tlf.local_flow_field(tw, 3, 31,
                                                         min_events=0)
        assert torch.equal(nx[g], got[0]) and torch.equal(iters[g], got[2])


def test_local_state_has_the_jax_fields():
    assert tlf.LocalState._fields == jlf.LocalState._fields
    s = tlf.LocalState(*(torch.zeros(()) for _ in tlf.LocalState._fields))
    assert s.iters.dim() == 0


# ----------------------------------------------------- the model, the slice


@pytest.mark.parametrize("seed", [0, 1])
def test_pretty_is_the_jax_string(seed):
    rng = np.random.default_rng(seed)
    vals = {f: np.float32(rng.normal(0, 10)) for f in JaxModel._fields}
    vals["cnt"] = np.float32(rng.integers(0, 10_000))
    mj = JaxModel.zero()._replace(**{k: jnp.float32(v)
                                     for k, v in vals.items()})
    mt = MotionModel.zero().replace(**{k: torch.tensor(v)
                                       for k, v in vals.items()})
    assert mt.pretty() == mj.pretty()
    assert MotionModel.zero().pretty() == JaxModel.zero().pretty()


def _jax_params(path, fn):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            return [a.arg for a in node.args.args]
    raise AssertionError(fn)


def test_jit_event_parallel_has_the_jax_parameters():
    want = _jax_params("better_flow_tpu/parallel/event_parallel.py",
                       "jit_event_parallel")
    assert list(inspect.signature(tep.jit_event_parallel).parameters) == want
    assert _jax_params("better_flow_tpu/models/local_flow.py",
                       "local_flow_window") == list(
        inspect.signature(tlf.local_flow_window).parameters)
