"""merklekv_tpu_torch: the PyTorch/CUDA port of merklekv_tpu.

The JAX package (``merklekv_tpu``) stays the reference; this package mirrors
its paths (``ops/``, ``merkle/``, ``cluster/``, ``parallel/``, ``storage/``,
``requestplane/``, ``obs/``, ``native/``) and keeps its own copies of the host modules it needs. It imports ``torch`` and
numpy, never ``jax`` and nothing from ``merklekv_tpu``. The SHA-256 kernels
are hand-written CUDA in ``csrc/``, built with ``nvcc`` at first use; the
native engine and server are the C++ copy in ``native/``, built with ``g++``
at first use. ``python -m merklekv_tpu_torch`` starts a node or runs one of
the JAX package's subcommands (``__main__``).

The code below is a copy of ``merklekv_tpu/__init__.py``: the package
exports ``__version__`` (``version.py``), and each subpackage's
``__init__`` exports the names of its JAX counterpart.
"""

from merklekv_tpu_torch.version import __version__

__all__ = ["__version__"]
