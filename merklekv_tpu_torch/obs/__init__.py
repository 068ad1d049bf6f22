"""Observability of the torch port: the metrics registry (``metrics``), the
flight recorder (``flightrec``), anti-entropy cycle traces (``trace``), the
causal-trace wire (``tracewire``), the convergence-lag plane (``lag``) and
the Prometheus exporter (``exporter``, ``catalog``): copies of the JAX
package's ``obs/`` modules."""
