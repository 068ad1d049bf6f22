"""The torch port's public surface against the JAX package's, on the CPU.

- Package names: every name in the ``__all__`` of each JAX package
  (``merklekv_tpu`` and its ten subpackages) imports from the port's
  counterpart and is the port's own object (defined in
  ``merklekv_tpu_torch``). ``import merklekv_tpu_torch.ops`` loads no kernel
  module and starts no compiler.
- ``utils.device_profile``: a plain rebuild+diff under it writes a
  TensorBoard trace and returns exactly what the same call returns without
  it (on the card, ``tests/test_torch_cuda.py`` checks that the trace
  names the kernels).
- ``device.ladder.build_state_with_ladder`` against the JAX function: the
  same seeded items and ``top_shards``, with and without a fault injected
  at the top rung through each package's own ``testing/device_faults``,
  walk the same rungs (``on_step``) to the same rung, and the state's root
  and every TREELEVEL slice equal the CPU golden tree, after an update and
  an insert/delete batch too. Without CPU devices (what a card does) the
  ladder ends at rung 1, and the function raises when every rung fails.

Tolerance everywhere: exact equality.
"""

import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from merklekv_tpu.device.ladder import build_state_with_ladder as jax_build_with_ladder
from merklekv_tpu.testing.device_faults import DeviceFaultInjector as JaxInjector
from merklekv_tpu_torch.device.ladder import build_state_with_ladder
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.cpu import build_levels
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector
from merklekv_tpu_torch.utils import device_profile

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ["", "cluster", "device", "merkle", "obs", "ops", "parallel", "requestplane",
            "storage", "testing", "utils"]


# ------------------------------------------------------------ package names

@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "root")
def test_package_exports_the_jax_names(sub):
    suffix = f".{sub}" if sub else ""
    jax_pkg = importlib.import_module("merklekv_tpu" + suffix)
    port = importlib.import_module("merklekv_tpu_torch" + suffix)
    want = list(getattr(jax_pkg, "__all__", []))
    assert set(want) <= set(getattr(port, "__all__", [])), sorted(set(want) - set(port.__all__))
    for name in want:
        obj, ref = getattr(port, name), getattr(jax_pkg, name)
        if isinstance(obj, types.ModuleType):
            assert obj.__name__.startswith("merklekv_tpu_torch."), (name, obj.__name__)
        elif callable(obj):
            assert obj.__module__.startswith("merklekv_tpu_torch."), (name, obj.__module__)
        elif isinstance(obj, (str, int, float, tuple)):
            assert obj == ref, name  # a constant of the shared spec
        else:
            assert obj is not ref and type(obj) is type(ref), name  # e.g. a sentinel


_OPS_IMPORT = r"""
import subprocess, sys
def refuse(*a, **k):
    raise AssertionError(f"a process was started: {a[:1]}")
subprocess.Popen.__init__ = refuse
import merklekv_tpu_torch.ops as ops
assert "merklekv_tpu_torch.ops.sha256_cuda" not in sys.modules
assert "merklekv_tpu_torch.ops.cuda_lib" not in sys.modules
assert "merklekv_tpu_torch.ops.merkle_paths" not in sys.modules
assert ops.sha256_blocks.__module__ == "merklekv_tpu_torch.ops.sha256"
print("ok")
"""


def test_importing_ops_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _OPS_IMPORT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------------ device_profile

def _forward(device):
    blocks, nblocks, digests, present = _example_batch(64, 3)
    return te.anti_entropy_forward(blocks, nblocks, digests, present, device=device)


def test_device_profile_writes_a_trace_and_changes_nothing(tmp_path):
    logdir = tmp_path / "trace"
    with device_profile(str(logdir)):
        got = _forward("cpu")
    want = _forward("cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0, list(logdir.iterdir())
    names = {ev.get("name", "") for ev in json.loads(traces[0].read_text())["traceEvents"]}
    assert names, "the trace holds no event"
    keys = [f"key:{i:06d}".encode() for i in range(64)]
    values = [f"value-{i}".encode() for i in range(64)]
    golden = build_levels([leaf_hash(k, v) for k, v in zip(keys, values)])[-1][0]
    assert got[0].numpy().astype(">u4").tobytes() == golden


# ------------------------------------------------------------ build_state_with_ladder

CPU4 = ["cpu"] * 4


def _items(seed: int = 7, n: int = 37) -> dict:
    rng = np.random.default_rng(seed)
    keys = {b"lad:%06d" % k for k in rng.integers(0, 10**6, size=n)}
    return {k: b"v%d" % rng.integers(0, 1000) for k in sorted(keys)}


def _golden_levels(items: dict) -> list:
    return build_levels([leaf_hash(k, v) for k, v in sorted(items.items())])


def _check_golden(state, items: dict) -> None:
    glv = _golden_levels(items)
    assert state.root_hex() == glv[-1][0].hex()
    for lvl, level in enumerate(glv):
        rows, n_live = state.level_nodes(lvl, 0, len(level))
        assert n_live == len(items) and [d for _, d in rows] == level, lvl


def _drive(state, items: dict) -> None:
    """The multichip probe's serving checks: build, an update, an insert
    and a delete, every root and slice against the golden tree."""
    _check_golden(state, items)
    k0, k1 = sorted(items)[:2]
    items[k0] = b"updated"
    state.apply([(k0, b"updated")])
    items[b"lad:zz"] = b"inserted"
    del items[k1]
    state.apply([(b"lad:zz", b"inserted"), (k1, None)])
    _check_golden(state, items)


def _run_both(fault, top_shards: int = 4):
    """Both functions on the same items; ``fault`` (a label glob or None)
    fails every matching dispatch in each package's own injector."""
    steps = {"jax": [], "torch": []}
    results = {}
    for name, build, inj_cls, kw in (
        ("jax", jax_build_with_ladder, JaxInjector, {}),
        ("torch", build_state_with_ladder, DeviceFaultInjector, {"devices": CPU4}),
    ):
        items = _items()
        inj = inj_cls(match=fault, mode="fail").install() if fault else None
        try:
            state, rung = build(items.items(), top_shards,
                                on_step=lambda r, e, s=steps[name]: s.append(r), **kw)
        finally:
            if inj is not None:
                inj.uninstall()
        _drive(state, items)
        results[name] = (rung, type(state).__name__)
    return steps, results


@pytest.mark.parametrize("fault,want_steps,want_rung", [
    (None, [], 4),
    ("shard4_*", [4], 2),
    ("shard*", [4, 2], 1),
    ("*", [4, 2, 1], 0),
], ids=["clean", "top-rung", "every-sharded-rung", "every-device-rung"])
def test_build_state_with_ladder_matches_jax(fault, want_steps, want_rung):
    steps, results = _run_both(fault)
    assert steps["torch"] == steps["jax"] == want_steps
    assert results["torch"][0] == results["jax"][0] == want_rung
    assert results["torch"][1] == results["jax"][1]


def test_build_state_with_ladder_without_devices_means_cuda(monkeypatch):
    """What a card does: without devices every rung is on CUDA, and the
    ladder ends at rung 1, so when every rung fails the last error is
    raised instead of building on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-GPU behaviour is not observable")
    monkeypatch.delenv("MERKLEKV_TORCH_DEVICE", raising=False)
    steps = []
    with pytest.raises(RuntimeError, match="CUDA"):
        build_state_with_ladder(_items().items(), 2, on_step=lambda r, e: steps.append(r))
    assert steps == [2, 1]
