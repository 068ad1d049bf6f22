"""Cluster control plane of the torch port: the node (``node``), the
anti-entropy manager (``sync``), replication (``replicator``, ``applier``,
``change_event``, ``transport``, ``transport_mqtt``), peer health and
overload (``health``, ``overload``), the retry policies (``retry``) and the
serving mirror (``mirror``). Copies of the JAX package's ``cluster/``
modules; each docstring says what differs."""
