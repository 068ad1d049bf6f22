"""Features of the JAX package that the torch port does not have yet.

Each one raises ``NotImplementedError`` naming the ROADMAP item that will
bring it, where the JAX package would have started it: a config that asks
for one, the node's lazy import of its module, or the CLI subcommand. None
is ignored silently, and none fails as an ``ImportError``.
"""

from __future__ import annotations

import os
import types
from typing import NoReturn

__all__ = ["FEATURES", "SUBCOMMANDS", "refuse", "refuse_config"]

# The names the JAX node imports from these features' modules stand here as
# callables that refuse: the port's node imports them from this module, so
# reaching one raises ``NotImplementedError`` instead of ``ImportError``.

# feature -> (what it is, its ROADMAP item)
FEATURES = {
    "multihost": ("the multi-host device mesh (MKV_COORDINATOR)",
                  "ROADMAP Queue A item 4"),
    "storage": ("durable storage ([storage] enabled / --durable, storage/)",
                "ROADMAP Queue A item 6"),
    "partitions": ("partitioned cluster mode and live rebalancing "
                   "([cluster] partitions > 0, partmap, rebalance)",
                   "ROADMAP Queue A item 7"),
    "bootstrap": ("snapshot bootstrap of a joining node ([bootstrap] enabled)",
                  "ROADMAP Queue A item 8"),
}
# CLI subcommands of ``python -m merklekv_tpu`` the port does not run yet.
SUBCOMMANDS = ("walcheck", "top", "blackbox", "router", "rebalance")


def refuse(feature: str) -> NoReturn:
    if feature in SUBCOMMANDS:
        raise NotImplementedError(
            f"the {feature!r} subcommand is not in the torch port yet "
            "(ROADMAP Queue A item 9)"
        )
    what, item = FEATURES[feature]
    raise NotImplementedError(f"{what} is not in the torch port yet ({item})")


def refuse_config(cfg) -> None:
    """Raise for the first feature ``cfg`` (or the environment) asks for that
    the port does not have."""
    if os.environ.get("MKV_COORDINATOR"):
        refuse("multihost")
    if cfg.storage.enabled:
        refuse("storage")
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
load_map_file = _refusing("partitions", "load_map_file")
save_map_file = _refusing("partitions", "save_map_file")
key_in_range = _refusing("partitions", "key_in_range")
RebalanceManager = _refusing("partitions", "RebalanceManager")
BootstrapSession = _refusing("bootstrap", "BootstrapSession")
DurableStore = _refusing("storage", "DurableStore")
node_data_dir = _refusing("storage", "node_data_dir")
# The JAX package's ``parallel.multihost`` module: every function refuses.
multihost = types.SimpleNamespace(**{
    name: _refusing("multihost", name)
    for name in ("initialize", "is_initialized", "process_count", "process_index",
                 "global_key_mesh", "lift_local_shards")
})
