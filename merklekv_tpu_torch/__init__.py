"""merklekv_tpu_torch: the PyTorch/CUDA port of merklekv_tpu.

The JAX package (``merklekv_tpu``) stays the reference; this package mirrors
its paths (``ops/``, ``merkle/``, ``cluster/``, ``obs/``, ``native/``) and
keeps its own copies of the host modules it needs. It imports ``torch`` and
numpy, never ``jax`` and nothing from ``merklekv_tpu``. The SHA-256 kernels
are hand-written CUDA in ``csrc/``, built with ``nvcc`` at first use; the
native engine and server are the C++ copy in ``native/``, built with ``g++``
at first use. ``python -m merklekv_tpu_torch`` starts a node (``__main__``);
what it does not do yet raises ``NotImplementedError`` (``unported.py``).
"""
