"""The command itself: no result without the cell's cards or without the
program, and small cells correct on a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "ae10m-r8.cycle", "--seed", "5", "--seconds", "1", "--trace", "0"]


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_result_in_a_directory_of_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell,over", [
    ("ae10m-r8.cycle", {"keys": 100_003, "warmup_cycles": 1}),
    ("kv1m-ycsb.u11k", {"keys": 50_000, "rate_writes_per_s": 11_000, "warmup_s": 0.5,
                         "stamp_samples": 3}),
])
def test_small_cells_correct_on_the_card(cuda, cell, over):
    from portbench import harness

    r = harness.run_cell(cell, 4_100_000_001, 2.0, True, [cuda], overrides=over,
                         bench=harness.load_bench(pending=True))
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    json.dumps(r)
