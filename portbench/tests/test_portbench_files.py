"""BENCHMARK.json and the files it names: the contract's shapes, and every
configuration, traffic mix and reader loads."""

import ast
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PENDING = json.loads((HERE / "pending.json").read_text())
# BENCHMARK.json with pending.json's cells: what the tools and tests run.
BOTH = {k: BENCH[k] + PENDING[k] for k in ("configs", "workloads", "end_to_end", "per_layer")}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "merklekv_tpu"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 180 s
    # a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [e["why"] for e in BENCH["configs"] + BENCH["workloads"]] \
            + [e["source"] for e in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in cells:
        here = [m for m in e2e.values() if "workloads" not in m or w in m["workloads"]]
        assert len(here) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    # At most a quarter of the cells (and always one) ask for four chips.
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)


def test_pending_entries_have_their_keys_and_are_not_run():
    from portbench import harness

    assert set(PENDING) == {"why", "configs", "workloads", "end_to_end", "per_layer"}
    for m in PENDING["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source"}
    for m in PENDING["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in PENDING["end_to_end"]}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BOTH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in PENDING["workloads"]:
        with pytest.raises(SystemExit):
            harness.find(harness.load_bench()["workloads"], w["name"], "workload")
        assert harness.find(harness.load_bench(pending=True)["workloads"], w["name"], "workload")


@pytest.mark.parametrize("cfg", BOTH["configs"], ids=lambda c: c["name"])
def test_config_files_load(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("portbench/configs/")
    body = json.loads(path.read_text())
    assert body["source"] == cfg["source"]
    assert set(cfg["reduced"]) == set(body["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key)
    assert sum(w["config"] == cfg["name"] for w in BOTH["workloads"]) >= 1


@pytest.mark.parametrize("cell", BOTH["workloads"], ids=lambda w: w["name"])
def test_traffic_and_driver_load(cell):
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    mod = importlib.import_module(f"portbench.traffic.{mix['driver']}")
    assert hasattr(mod, "Cell") and mod.Cell.CONTROLS


@pytest.mark.parametrize("metric", BOTH["per_layer"], ids=lambda m: m["name"])
def test_readers_load(metric):
    from portbench import harness

    assert callable(harness.load_reader(metric["name"]))


def test_overrides_name_only_keys_the_cell_has():
    import torch

    from portbench import harness

    cpu = [torch.device("cpu")]
    ctx = harness.Ctx(BENCH, "ae10m-r8.cycle", 1, 1.0, False, cpu, {"keys": 8, "warmup_cycles": 0})
    assert ctx.config["keys"] == 8 and ctx.mix["warmup_cycles"] == 0
    with pytest.raises(KeyError):
        harness.Ctx(BENCH, "ae10m-r8.cycle", 1, 1.0, False, cpu, {"key": 8})


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    names = _imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(HERE).parts:
        assert "merklekv_tpu_torch" not in names


def test_import_check_compares_whole_names():
    from portbench.harness import FORBIDDEN as HARNESS_FORBIDDEN, forbidden_modules

    assert set(HARNESS_FORBIDDEN) == FORBIDDEN
    assert "merklekv_tpu_torch".split(".")[0] not in FORBIDDEN
    assert isinstance(forbidden_modules(), list)
