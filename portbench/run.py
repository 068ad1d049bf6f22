#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and ``checks`` last: each compared number beside
its limit, also the last lines of standard error). Exits nonzero, with no
result, when the cell's CUDA cards are not there or the run loaded JAX or
the JAX package.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout, so that only
# a cell's first run in a checkout builds or compiles anything.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
# The checkout's root, not this directory, is where imports resolve.
sys.path[0] = ROOT

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=min(T_START, harness.process_start_s())))
