"""Features of the JAX package that the torch port does not have yet.

Each one raises ``NotImplementedError`` naming the ROADMAP item that will
bring it, where the JAX package would have started it: a config that asks
for one, the node's lazy import of its module, or the CLI subcommand. None
is ignored silently, and none fails as an ``ImportError``.
"""

from __future__ import annotations

import os
from typing import NoReturn, Optional

__all__ = ["FEATURES", "SUBCOMMANDS", "refuse", "refuse_config"]

# The names the JAX node imports from these features' modules stand here as
# callables that refuse: the port's node imports them from this module, so
# reaching one raises ``NotImplementedError`` instead of ``ImportError``.

# feature -> (what it is, its ROADMAP item)
FEATURES = {
    "partitions": ("partitioned cluster mode and live rebalancing "
                   "([cluster] partitions > 0, partmap, rebalance)",
                   "ROADMAP Queue A item 4"),
    "bootstrap": ("snapshot bootstrap of a joining node ([bootstrap] enabled)",
                  "ROADMAP Queue A item 5"),
    "multihost_2d": ("a 2-D (replica, key) mesh across processes "
                     "(global_key_mesh(replicas > 0), sharded_divergence_2d)",
                     "ROADMAP Queue A item 7"),
}
# CLI subcommands of ``python -m merklekv_tpu`` the port does not run yet,
# and their ROADMAP items.
SUBCOMMANDS = {
    "top": "ROADMAP Queue A item 6",
    "blackbox": "ROADMAP Queue A item 6",
    "router": "ROADMAP Queue A item 4",
    "rebalance": "ROADMAP Queue A item 4",
}
# File name under a node's data directory where the JAX package persists a
# committed partition map (``merklekv_tpu/cluster/partmap.py``).
_MAP_FILE_NAME = "partmap.spec"


def refuse(feature: str) -> NoReturn:
    if feature in SUBCOMMANDS:
        raise NotImplementedError(
            f"the {feature!r} subcommand is not in the torch port yet "
            f"({SUBCOMMANDS[feature]})"
        )
    what, item = FEATURES[feature]
    raise NotImplementedError(f"{what} is not in the torch port yet ({item})")


def refuse_config(cfg) -> None:
    """Raise for the first feature ``cfg`` asks for that the port does not
    have."""
    if cfg.cluster.partitions > 0:
        refuse("partitions")
    if cfg.bootstrap.enabled:
        refuse("bootstrap")


def _refusing(feature: str, name: str):
    def refused(*args, **kwargs) -> NoReturn:
        refuse(feature)

    refused.__name__ = refused.__qualname__ = name
    return refused


parse_map_spec = _refusing("partitions", "parse_map_spec")
save_map_file = _refusing("partitions", "save_map_file")
key_in_range = _refusing("partitions", "key_in_range")
RebalanceManager = _refusing("partitions", "RebalanceManager")
BootstrapSession = _refusing("bootstrap", "BootstrapSession")


def load_map_file(directory: str) -> Optional[tuple]:
    """A durable node's committed partition map: ``None`` when its data
    directory holds none (every directory the port writes), else refused —
    a node the JAX package left in a partition cannot start as a whole
    keyspace."""
    if not os.path.exists(os.path.join(directory, _MAP_FILE_NAME)):
        return None
    refuse("partitions")
