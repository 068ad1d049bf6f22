"""Observability of the torch port: the metrics registry (``metrics``) and
the flight recorder's event ring (``flightrec``), copies of the JAX
package's ``obs/`` modules (see each module's docstring for what it keeps)."""
