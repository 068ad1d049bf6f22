"""Fault-contained device runtime under the torch serving tree (copies of
``merklekv_tpu/device/``).

- ``guard`` — deadline-guarded dispatch: every device call of the serving
  tree runs on its own thread under a bounded deadline, classified failures
  retry once, wedged dispatches are abandoned.
- ``ladder`` — the degradation ladder: on repeated dispatch failure the
  serving backend steps sharded(N) -> ... -> single device, on to the CPU
  golden tree only where the caller asked for the CPU (roots bit-identical
  at every rung), with a background probe climbing back up.

A copy of ``merklekv_tpu/device/__init__.py``, which exports no names.
"""
