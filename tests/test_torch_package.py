"""Package rules of the torch port, checked on the CPU.

- ``merklekv_tpu_torch`` imports neither ``jax`` nor anything of
  ``merklekv_tpu``: every module imports in a process where both are
  blocked, and no source file names either in an import statement (which
  also covers imports inside functions).
- Entry points called without ``device=`` mean CUDA: on a machine without a
  GPU they raise instead of running on the CPU.
- The kernel build fails loudly without ``nvcc``; nothing is built when a
  module is imported.
- A module copied from the JAX package says so in its docstring, naming
  the file it copies.
"""

import ast
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import merklekv_tpu_torch
from merklekv_tpu_torch import native_bindings
from merklekv_tpu_torch.__main__ import start
from merklekv_tpu_torch.cluster import sync as t_sync
from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.device.ladder import build_state_for_rung
from merklekv_tpu_torch.merkle import diff as t_diff
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
from merklekv_tpu_torch.ops import sha256_cuda
from merklekv_tpu_torch.utils.torchenv import as_tensor, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(merklekv_tpu_torch.__file__).resolve().parent
MODULES = sorted(
    ".".join(("merklekv_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)

_BLOCKED_IMPORT = r"""
import importlib, sys
sys.modules["jax"] = None          # any `import jax` raises ImportError
sys.modules["merklekv_tpu"] = None  # so does any import of the JAX package
for name in sys.argv[1:]:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "merklekv_tpu."))
               for m in sys.modules if sys.modules[m] is not None), sorted(sys.modules)
print("ok", len(sys.argv) - 1)
"""


# Modules copied, whole or in part, from the JAX package, and what each
# docstring names as its source.
COPIES = {
    "merklekv_tpu_torch.utils.errorkind": "merklekv_tpu/utils/errorkind.py",
    "merklekv_tpu_torch.utils.tracing": "merklekv_tpu/utils/tracing.py",
    "merklekv_tpu_torch.obs.metrics": "merklekv_tpu/obs/metrics.py",
    "merklekv_tpu_torch.obs.flightrec": "merklekv_tpu/obs/flightrec.py",
    "merklekv_tpu_torch.cluster.retry": "merklekv_tpu/cluster/retry.py",
    "merklekv_tpu_torch.cluster.change_event": "merklekv_tpu/cluster/change_event.py",
    "merklekv_tpu_torch.cluster.mirror": "merklekv_tpu/cluster/mirror.py",
    "merklekv_tpu_torch.device.guard": "merklekv_tpu/device/guard.py",
    "merklekv_tpu_torch.device.ladder": "merklekv_tpu/device/ladder.py",
    "merklekv_tpu_torch.testing.device_faults": "merklekv_tpu/testing/device_faults.py",
    "merklekv_tpu_torch.merkle.cpu_state": "merklekv_tpu.merkle.cpu_state",
    "merklekv_tpu_torch.config": "merklekv_tpu/config.py",
    "merklekv_tpu_torch.version": "merklekv_tpu/version.py",
    "merklekv_tpu_torch.native_bindings": "merklekv_tpu/native_bindings.py",
    "merklekv_tpu_torch.client": "merklekv_tpu/client.py",
    "merklekv_tpu_torch.broker": "merklekv_tpu/broker.py",
    "merklekv_tpu_torch.cluster.applier": "merklekv_tpu/cluster/applier.py",
    "merklekv_tpu_torch.cluster.transport": "merklekv_tpu/cluster/transport.py",
    "merklekv_tpu_torch.cluster.transport_mqtt": "merklekv_tpu/cluster/transport_mqtt.py",
    "merklekv_tpu_torch.cluster.replicator": "merklekv_tpu/cluster/replicator.py",
    "merklekv_tpu_torch.cluster.overload": "merklekv_tpu/cluster/overload.py",
    "merklekv_tpu_torch.cluster.health": "merklekv_tpu/cluster/health.py",
    "merklekv_tpu_torch.cluster.sync": "merklekv_tpu/cluster/sync.py",
    "merklekv_tpu_torch.cluster.node": "merklekv_tpu/cluster/node.py",
    "merklekv_tpu_torch.obs.trace": "merklekv_tpu/obs/trace.py",
    "merklekv_tpu_torch.obs.tracewire": "merklekv_tpu/obs/tracewire.py",
    "merklekv_tpu_torch.obs.lag": "merklekv_tpu/obs/lag.py",
    "merklekv_tpu_torch.obs.exporter": "merklekv_tpu/obs/exporter.py",
    "merklekv_tpu_torch.obs.catalog": "merklekv_tpu/obs/catalog.py",
}


def test_every_module_imports_without_jax_or_the_jax_package():
    assert len(MODULES) >= 12, MODULES
    assert set(COPIES) <= set(MODULES), sorted(set(COPIES) - set(MODULES))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, *MODULES],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(MODULES)}"


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copied_module_docstring_names_its_source(module):
    doc = " ".join((importlib.import_module(module).__doc__ or "").split())
    assert "copy of" in doc and f"``{COPIES[module]}" in doc, (module, doc[:200])


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "merklekv_tpu"), f"{path}: imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-GPU behaviour is not observable")
    monkeypatch.delenv("MERKLEKV_TORCH_DEVICE", raising=False)


def _node_config() -> Config:
    cfg = Config()
    cfg.port = 0
    return cfg


_ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "leaf_digests": lambda: te.leaf_digests([b"k"], [b"v"]),
    "anti_entropy_forward": lambda: te.anti_entropy_forward(
        np.zeros((1, 1, 16), np.uint32), np.ones(1, np.int32),
        np.zeros((2, 1, 8), np.uint32), np.ones((2, 1), bool)),
    "TorchMerkleTree": lambda: te.TorchMerkleTree(),
    "DeviceMerkleState": lambda: DeviceMerkleState(),
    "DeviceMerkleState.from_items": lambda: DeviceMerkleState.from_items([(b"k", b"v")]),
    "DeviceMerkleState.from_levels": lambda: DeviceMerkleState.from_levels([], []),
    "diff_keys_pair": lambda: t_diff.diff_keys_pair({b"a": b"x" * 32}, {}),
    "DeviceTreeMirror": lambda: DeviceTreeMirror(object()),
    "build_state_for_rung(1)": lambda: build_state_for_rung(1, [(b"k", b"v")]),
    "node start": lambda: start(_node_config()),
    "SyncManager leaf pass": lambda: t_sync.SyncManager(object(), device="tpu")._hash_leaves(
        [(b"k", b"v")], True),
    "SyncManager pairwise diff": lambda: t_sync.SyncManager(object(), device="tpu")._diff(
        {b"a": b"x" * 32}, {}, True),
    "divergence_masks_engine": lambda: t_diff.divergence_masks_engine(
        np.zeros((2, 1, 8), np.uint32), np.ones((2, 1), bool)),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name]()


def test_explicit_cpu_runs_and_other_devices_are_refused():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(TypeError):
        as_tensor(np.zeros(3, np.int64), torch.device("cpu"))
    with pytest.raises(ValueError):
        sha256_cuda.node_pairs_cuda(torch.zeros((1, 8), dtype=torch.int32),
                                    torch.zeros((1, 8), dtype=torch.int32, device="meta"))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(sha256_cuda, "BUILD_DIR", tmp_path / "build")
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        sha256_cuda.build_kernels()
    assert sha256_cuda._kernels is None


def test_source_tag_covers_sources_and_flags():
    tag = sha256_cuda._source_tag()
    assert len(tag) == 16 and tag == sha256_cuda._source_tag()
    assert sha256_cuda.BUILD_DIR == ROOT / "build" / "torch_kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_native_build_writes_only_under_build_native(tmp_path, monkeypatch):
    """The port's C++ copy builds into ``build/native/`` at the repository
    root (which ``.gitignore`` covers), named by a hash of its sources and
    flags, and leaves its source directory as it found it."""
    assert Path(native_bindings.BUILD_DIR) == ROOT / "build" / "native"
    src = Path(native_bindings._NATIVE_DIR)
    assert src == PKG / "native"
    before = sorted(p.name for p in src.iterdir())
    assert before and all(name.endswith((".cc", ".h")) for name in before)
    lib = Path(native_bindings.ensure_built())
    assert lib.parent == ROOT / "build" / "native" and lib.name.endswith(".so")
    assert sorted(p.name for p in src.iterdir()) == before
    # The name follows the sources: an edited copy gets another one.
    tag = native_bindings._source_tag()
    assert tag in lib.name and tag == native_bindings._source_tag()
    copy = tmp_path / "native"
    shutil.copytree(src, copy)
    (copy / "merkle.cc").write_text((copy / "merkle.cc").read_text() + "\n// edited\n")
    monkeypatch.setattr(native_bindings, "_NATIVE_DIR", str(copy))
    assert native_bindings._source_tag() != tag
