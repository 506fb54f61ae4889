#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``better_flow_tpu_torch`` and ``native``.  Needs a CUDA card; prints the
result as the last line of standard output (see ``portbench/harness.py``).
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds.  The port builds its own kernels into
# better_flow_tpu_torch/_build/ and native/.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "portbench" / ".cache" / sub)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
