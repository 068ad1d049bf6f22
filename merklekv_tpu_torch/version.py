"""Package version (a copy of ``merklekv_tpu/version.py``)."""

__version__ = "0.1.0"
