"""The runs of ``tests/test_fast_schedule.py``'s production-sensor gate
scenes, each made once in a test process, and the rule that holds a list of
``chip_smoke`` gates.  Shared by ``test_torch_fast_gates.py`` (the kernel
route) and ``test_torch_fast_gates_xla.py`` (the XLA branch).

The scenes, presets and gates are ``chip_smoke.py``'s (``gate_scene``,
``quality_opt``, ``FAST_GATES``), which the card's ``[quality]`` phase
evaluates the same way.  Run as a script it prints every gate's ratio for
one package and route, on the CPU (a few minutes), or with ``sweep`` and
scene names the AEE ratio and iteration fraction of the fast presets at
each of ``chip_smoke.SCENE_SEEDS``'s seeds::

    JAX_PLATFORMS=cpu python tests/fast_gate_runs.py jax pallas
    python tests/fast_gate_runs.py port auto
    JAX_PLATFORMS=cpu python tests/fast_gate_runs.py jax pallas sweep noisy
"""

import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

scene = functools.lru_cache(maxsize=None)(cs.gate_scene)


@functools.lru_cache(maxsize=None)
def port_runs(route):
    """``run(name, seed, preset)``: the port's scan on the CPU under
    ``scatter_mode=route`` ("auto" is the kernel route: the kernels' plain
    twins), each once."""
    from better_flow_tpu_torch.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu_torch.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    return cs.quality_runner(
        lambda d, cfg: compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                                 cfg, device="cpu"),
        PipelineConfig, OptimizerConfig, scene, scatter_mode=route)


@functools.lru_cache(maxsize=None)
def jax_runs(route):
    """The JAX package's scan under ``scatter_mode=route`` ("pallas": its
    kernels in interpret mode; "xla"), each once."""
    from better_flow_tpu.config import OptimizerConfig, PipelineConfig
    from better_flow_tpu.runtime.scan_pipeline import (
        compensate_recording_scan,
    )

    return cs.quality_runner(
        lambda d, cfg: compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                                 cfg),
        PipelineConfig, OptimizerConfig, scene, scatter_mode=route)


def hold(gates, limits=None):
    """Assert every gate, at the limit ``limits`` gives its label if any,
    else its own; the message lists the gates that failed with their
    ratios."""
    limits = limits or {}
    failed = [(g["label"], g["value"] / g["base"],
               limits.get(g["label"], g["limit"]))
              for g in gates if not cs.gate_held(g, limits.get(g["label"]))]
    assert not failed, failed


def iteration_parts(a, b):
    """The slices in which two runs' iteration counts differ."""
    return np.flatnonzero(a["iters"] != b["iters"]).tolist()


def sweep(runs, names):
    """Print each fast preset's AEE ratio against the reference schedule
    and iteration fraction at every seed of the scenes ``names``, with
    their seed mean and max, a line for each scene and preset."""
    for name in names:
        for preset in cs.QUALITY_PRESETS[1:]:
            rows = []
            for seed in cs.SCENE_SEEDS[name]:
                d, mask = scene(name, seed)
                ref, out = runs(name, seed, "reference"), runs(name, seed,
                                                               preset)
                rows.append((cs.aee_med(out, d, mask)
                             / cs.aee_med(ref, d, mask),
                             out["iters"].sum() / ref["iters"].sum()))
            ratio, frac = np.array(rows).T
            print(json.dumps(dict(scene=name, preset=preset,
                                  ratios=ratio.tolist(),
                                  ratio_mean=ratio.mean(),
                                  ratio_max=ratio.max(),
                                  iterfrac_mean=frac.mean())))


if __name__ == "__main__":
    package, route = sys.argv[1:3]
    runs = (jax_runs if package == "jax" else port_runs)(route)
    if sys.argv[3:4] == ["sweep"]:
        sweep(runs, sys.argv[4:] or list(cs.SCENE_SEEDS))
        sys.exit(0)
    for gates_of in cs.FAST_GATES.values():
        for g in gates_of(runs, scene):
            print(json.dumps(dict(label=g["label"],
                                  ratio=g["value"] / g["base"],
                                  limit=g["limit"],
                                  held=cs.gate_held(g))))
    print(json.dumps(dict(noisy_31_reference_iterations=runs(
        "noisy", 31, "reference")["iters"].tolist())))
