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
  the file it copies (partitioned mode, rebalancing, bootstrap and the
  request plane among them).
- Each copy equals its source once ``merklekv_tpu_torch`` is read as
  ``merklekv_tpu`` and docstrings and comments are dropped (Python: the
  two syntax trees; C++: the lines outside comments), so the JAX package's
  tests cover the copy too. The copies that differ in code are listed in
  ``DIVERGES`` with the reason; a listed copy that has become equal fails,
  so the list cannot go stale.
"""

import ast
import importlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import merklekv_tpu_torch
from merklekv_tpu_torch import native_bindings
from merklekv_tpu_torch.__main__ import main as cli_main
from merklekv_tpu_torch.__main__ import start
from merklekv_tpu_torch.cluster import rebalance as t_rebalance
from merklekv_tpu_torch.cluster import sync as t_sync
from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.device.ladder import build_state_for_rung
from merklekv_tpu_torch.merkle import diff as t_diff
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
from merklekv_tpu_torch.ops import cuda_lib, sha256_cuda
from merklekv_tpu_torch.parallel import ShardedDeviceMerkleState, make_mesh, multihost
from merklekv_tpu_torch.storage import compute_root_hex
from merklekv_tpu_torch.storage import snapshot as snapmod
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
    "merklekv_tpu_torch": "merklekv_tpu/__init__.py",
    "merklekv_tpu_torch.cluster": "merklekv_tpu/cluster/__init__.py",
    "merklekv_tpu_torch.device": "merklekv_tpu/device/__init__.py",
    "merklekv_tpu_torch.merkle": "merklekv_tpu/merkle/__init__.py",
    "merklekv_tpu_torch.obs": "merklekv_tpu/obs/__init__.py",
    "merklekv_tpu_torch.ops": "merklekv_tpu/ops/__init__.py",
    "merklekv_tpu_torch.testing": "merklekv_tpu/testing/__init__.py",
    "merklekv_tpu_torch.utils": "merklekv_tpu/utils/__init__.py",
    "merklekv_tpu_torch.merkle.encoding": "merklekv_tpu.merkle.encoding",
    "merklekv_tpu_torch.merkle.cpu": "merklekv_tpu.merkle.cpu",
    "merklekv_tpu_torch.merkle.packing": "merklekv_tpu.merkle.packing",
    "merklekv_tpu_torch.obs.top": "merklekv_tpu/obs/top.py",
    "merklekv_tpu_torch.obs.blackbox": "merklekv_tpu/obs/blackbox.py",
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
    "merklekv_tpu_torch.storage": "merklekv_tpu/storage/__init__.py",
    "merklekv_tpu_torch.storage.wal": "merklekv_tpu/storage/wal.py",
    "merklekv_tpu_torch.storage.snapshot": "merklekv_tpu/storage/snapshot.py",
    "merklekv_tpu_torch.storage.store": "merklekv_tpu/storage/store.py",
    "merklekv_tpu_torch.storage.walcheck": "merklekv_tpu/storage/walcheck.py",
    "merklekv_tpu_torch.testing.faults": "merklekv_tpu/testing/faults.py",
    "merklekv_tpu_torch.cluster.partmap": "merklekv_tpu/cluster/partmap.py",
    "merklekv_tpu_torch.cluster.router": "merklekv_tpu/cluster/router.py",
    "merklekv_tpu_torch.cluster.rebalance": "merklekv_tpu/cluster/rebalance.py",
    "merklekv_tpu_torch.cluster.bootstrap": "merklekv_tpu/cluster/bootstrap.py",
    "merklekv_tpu_torch.requestplane": "merklekv_tpu/requestplane/__init__.py",
    "merklekv_tpu_torch.requestplane.__main__": "merklekv_tpu/requestplane/__main__.py",
    "merklekv_tpu_torch.requestplane.cache": "merklekv_tpu/requestplane/cache.py",
    "merklekv_tpu_torch.requestplane.invalidation": "merklekv_tpu/requestplane/invalidation.py",
    "merklekv_tpu_torch.requestplane.router": "merklekv_tpu/requestplane/router.py",
}
# Copies that differ from their source in code, and why. Every other copy
# equals its source (see test_copy_equals_its_source).
DIVERGES = {
    "merklekv_tpu_torch.cluster.mirror": "torch devices; on the card the ladder ends at rung 1 "
                                         "and every failed drain invalidates and re-warms",
    "merklekv_tpu_torch.cluster.node": "the node's torch device; a failed tree query answers an "
                                       "error, not the host tree; PROFILE captures torch.profiler",
    "merklekv_tpu_torch.cluster.rebalance": "the moving range's root and the joiner's snapshot "
                                            "check run on the device",
    "merklekv_tpu_torch.cluster.sync": "device failures in the leaf pass, masks and diff are "
                                       "counted and raised, never redone on the host",
    "merklekv_tpu_torch.device.guard": "names its worker thread in GUARD_THREAD_NAME, which the "
                                       "port's tests read",
    "merklekv_tpu_torch.device.ladder": "torch build_state_for_rung; on the card the ladder and "
                                        "build_state_with_ladder end at rung 1",
    "merklekv_tpu_torch.native_bindings": "builds the port's native copy with g++ into "
                                          "build/native/, never into the source tree",
    "merklekv_tpu_torch.storage.snapshot": "a device failure in the snapshot root is raised, "
                                           "not recomputed on the host",
    "merklekv_tpu_torch.storage.walcheck": "roots are recomputed on the node's device by "
                                           "default (--engine tpu)",
    "merklekv_tpu_torch.testing.device_faults": "the default corruption flips a bit of a list "
                                                "of level tensors",
    "merklekv_tpu_torch.utils.tracing": "device_profile over torch.profiler, not jax.profiler; "
                                        "device_span and its ring for the data plane; span() "
                                        "builds its log line only when INFO is on",
}
# The native runtime: every C++ file of the port is a copy of the JAX one.
NATIVE_COPIES = sorted(p.name for p in (PKG / "native").iterdir())
# Scripts the torch tests spawn; held to the same import rules.
WORKERS = [ROOT / "tests" / "torch_multihost_worker.py"]


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


def _source_path(module: str) -> Path:
    src = COPIES[module]
    if src.endswith(".py"):
        return ROOT / src
    return ROOT / (src.replace(".", "/") + ".py")


def _python_code(path: Path) -> str:
    """The syntax tree of a module with the package name read as
    ``merklekv_tpu`` and every docstring dropped (comments never reach it)."""
    tree = ast.parse(path.read_text().replace("merklekv_tpu_torch", "merklekv_tpu"))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _cxx_code(path: Path) -> list[str]:
    """The non-blank lines of a C++ file outside ``//`` and ``/* */``
    comments (string and character literals kept whole), right-stripped."""
    text, out, i = path.read_text(), [], 0
    n = len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            i = text.find("\n", i)
            i = n if i < 0 else i
        elif text.startswith("/*", i):
            i = text.index("*/", i + 2) + 2
        elif c in "\"'":
            j = i + 1
            while text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    return [ln.rstrip() for ln in "".join(out).splitlines() if ln.strip()]


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_equals_its_source(module):
    port = Path(importlib.import_module(module).__file__)
    same = _python_code(port) == _python_code(_source_path(module))
    if module in DIVERGES:
        assert not same, f"{module} equals its source now: take it out of DIVERGES"
    else:
        assert same, f"{module} differs from {COPIES[module]} in code"


def test_divergent_copies_are_copies():
    assert set(DIVERGES) <= set(COPIES), sorted(set(DIVERGES) - set(COPIES))


@pytest.mark.parametrize("name", NATIVE_COPIES)
def test_native_copy_equals_its_source(name):
    assert name.endswith((".cc", ".h")), name
    port, src = PKG / "native" / name, ROOT / "merklekv_tpu" / "native" / name
    assert port.read_text().startswith(f"// A copy of merklekv_tpu/native/{name}"), name
    assert _cxx_code(port) == _cxx_code(src)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + WORKERS, ids=lambda p: p.name)
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


_BLOCKED_WORKER = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["merklekv_tpu"] = None
path = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_path(path, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert not any(m == "jax" or m.startswith(("jax.", "merklekv_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_multihost_worker_runs_without_jax_or_the_jax_package():
    """The rank script of ``tests/test_torch_multihost.py``, as one rank of
    a one-process group, in a process where both are blocked."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT), MKV_COORDINATOR=f"127.0.0.1:{port}",
               MKV_NUM_PROCESSES="1", MKV_PROCESS_ID="0", MERKLEKV_TORCH_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_WORKER, str(WORKERS[0]), "16", "2", "3", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "COUNTS 0,3" in out.stdout and "MASKS ok" in out.stdout, out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-GPU behaviour is not observable")
    monkeypatch.delenv("MERKLEKV_TORCH_DEVICE", raising=False)


def _node_config(partitioned: bool = False) -> Config:
    cfg = Config()
    cfg.port = 0
    if partitioned:
        cfg.cluster.partitions = 1
        cfg.cluster.partition_id = 0
        cfg.cluster.partition_map = "0=127.0.0.1:1"
    return cfg


def _walcheck_without_engine():
    """``python -m merklekv_tpu_torch walcheck <dir>`` with no ``--engine``
    over a one-key snapshot: the root is recomputed on the node's device."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        items = [(b"k", b"v")]
        snapmod.write_snapshot(d, 1, [(b"k", b"v", 1)], [], 0,
                               compute_root_hex(items, engine="cpu"))
        return cli_main(["walcheck", d, "--json"])


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
    "make_mesh": lambda: make_mesh(),
    "ShardedDeviceMerkleState": lambda: ShardedDeviceMerkleState(),
    "ShardedDeviceMerkleState.from_items": lambda: ShardedDeviceMerkleState.from_items(
        [(b"k", b"v")], shards=2),
    "build_state_for_rung(2)": lambda: build_state_for_rung(2, [(b"k", b"v")]),
    "snapshot root on the device": lambda: compute_root_hex([(b"k", b"v")], engine="tpu"),
    "global_key_mesh": lambda: multihost.global_key_mesh(),
    "walcheck with no --engine": _walcheck_without_engine,
    "partitioned node start": lambda: start(_node_config(partitioned=True)),
    "rebalance range root on the device": lambda: t_rebalance._range_root_hex(
        [(b"k", b"v")], "tpu"),
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
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build_kernels()
    assert cuda_lib._kernels is None


def test_source_tag_covers_sources_and_flags():
    tag = cuda_lib._source_tag()
    assert len(tag) == 16 and tag == cuda_lib._source_tag()
    assert cuda_lib.BUILD_DIR == ROOT / "build" / "torch_kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_source_tag_follows_every_csrc_file(tmp_path, monkeypatch):
    """The kernel library's name hashes every ``.cu`` and ``.cuh`` found in
    ``csrc/``, listed nowhere: a header added to a copy renames it."""
    tag = cuda_lib._source_tag()
    copy = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", copy)
    monkeypatch.setattr(cuda_lib, "_CSRC", copy)
    assert cuda_lib._source_tag() == tag
    (copy / "extra.cuh").write_text("#pragma once\n")
    assert cuda_lib._source_tag() != tag


_C_ENTRY = re.compile(r"^(?:int|const char\*) (mkv_\w+)\(([^)]*)\)", re.M)


def test_binding_table_is_the_csrc_entries():
    """``cuda_lib.ENTRIES`` binds exactly the ``mkv_*`` functions of the
    ``extern "C"`` blocks of ``csrc/*.cu``, each with its C parameters (a
    launch's last one its stream), and no module of ``ops/`` calls an entry
    outside it or binds one itself."""
    defined = {}
    for cu in sorted((PKG / "csrc").glob("*.cu")):
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', cu.read_text(), re.S):
            for name, params in _C_ENTRY.findall(block):
                defined[name] = [" ".join(a.split()) for a in params.split(",") if a.strip()]
    assert sorted(defined) == sorted(cuda_lib.ENTRIES)
    for name, entry in cuda_lib.ENTRIES.items():
        params = defined[name]
        assert len(params) == len(entry.argtypes) + bool(entry.launches), name
        assert (params[-1:] == ["void* stream"]) == bool(entry.launches), name
    assert set(cuda_lib.LAUNCHES) == {e.launches for e in cuda_lib.ENTRIES.values()
                                      if e.launches}
    for path in sorted((PKG / "ops").glob("*.py")):
        src = path.read_text()
        assert set(re.findall(r"[\"'](mkv_\w+)[\"']", src)) <= set(cuda_lib.ENTRIES), path.name
        if path.name != "cuda_lib.py":
            assert "argtypes" not in src and not re.search(r"\.mkv_\w+\(", src), path.name


_OPS_WITHOUT_DIFF = r"""
import importlib, sys
sys.modules["merklekv_tpu_torch.merkle.diff"] = None  # any import of it raises
for name in sys.argv[1:]:
    importlib.import_module(name)
print("ok", len(sys.argv) - 1)
"""


def test_ops_imports_without_merkle_diff():
    """The ``ops`` layer sits below ``merkle``: every module of it imports
    in a process where ``merkle.diff`` cannot be imported."""
    ops = [m for m in MODULES if m.startswith("merklekv_tpu_torch.ops.")]
    out = subprocess.run([sys.executable, "-c", _OPS_WITHOUT_DIFF, *ops], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and out.stdout.split() == ["ok", str(len(ops))], out.stderr


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
