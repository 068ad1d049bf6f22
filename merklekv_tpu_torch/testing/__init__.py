"""Test support shipped with the torch port: the fault-injection layer the
chaos tests drive (``faults``) and the device-plane fault injector
(``device_faults``). A copy of ``merklekv_tpu/testing/__init__.py``, which
exports no names.
"""
