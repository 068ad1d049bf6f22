"""ThreadSanitizer stress over the torch port's copy of the native runtime.

The counterpart of the JAX package's ``make -C merklekv_tpu/native tsan``:
every source of ``merklekv_tpu_torch/native/`` that the stress driver links
(``tsan_stress.cc`` included) is compiled with ``-fsanitize=thread`` into a
fresh directory under ``build/tsan/`` (which ``.gitignore`` covers), and the
binary runs server traffic, stop races and multi-thread engine loads with
``TSAN_OPTIONS=halt_on_error=1``: any report fails it. Marked ``slow`` (about
15 s with g++ on 8 cores):

    python -m pytest tests/test_torch_tsan.py -q -m slow
"""

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "merklekv_tpu_torch" / "native"
# The JAX Makefile's TSAN_SRCS and TSAN_FLAGS.
SOURCES = ("sha256.cc", "merkle.cc", "engine.cc", "events.cc", "protocol.cc", "server.cc",
           "tsan_stress.cc")
FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=thread", "-fPIE", "-pthread", "-Wall")


@pytest.mark.slow
def test_tsan_stress_over_the_port_native_copy():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    assert cxx, "g++ is needed to build the stress driver"
    out_root = ROOT / "build" / "tsan"
    out_root.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=out_root))
    try:
        objs = [out / src.replace(".cc", ".o") for src in SOURCES]
        procs = [subprocess.Popen([cxx, *FLAGS, "-c", str(NATIVE / src), "-o", str(obj)],
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(SOURCES, objs)]
        for src, p in zip(SOURCES, procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"{src}: {err}"
        binary = out / "tsan-stress"
        link = subprocess.run([cxx, *FLAGS, "-pie", *map(str, objs), "-o", str(binary)],
                              capture_output=True, text=True, timeout=300)
        assert link.returncode == 0, link.stderr
        run = subprocess.run([str(binary)], capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, TSAN_OPTIONS="halt_on_error=1"))
        assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-8000:]
        assert "TSAN STRESS PASS" in run.stdout and "WARNING: ThreadSanitizer" not in run.stderr
    finally:
        shutil.rmtree(out, ignore_errors=True)
