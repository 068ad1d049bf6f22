"""Features of the JAX package that the torch port does not have yet.

Each one raises ``NotImplementedError`` naming the ROADMAP item that will
bring it, where the JAX package would have started it: the call that asks
for it, or the CLI subcommand. None is ignored silently, and none fails as
an ``ImportError``.
"""

from __future__ import annotations

from typing import NoReturn

__all__ = ["FEATURES", "SUBCOMMANDS", "refuse"]

# feature -> (what it is, its ROADMAP item)
FEATURES = {
    "multihost_2d": ("a 2-D (replica, key) mesh across processes "
                     "(global_key_mesh(replicas > 0), sharded_divergence_2d)",
                     "ROADMAP Queue A item 7"),
}
# CLI subcommands of ``python -m merklekv_tpu`` the port does not run yet,
# and their ROADMAP items.
SUBCOMMANDS = {
    "top": "ROADMAP Queue A item 6",
    "blackbox": "ROADMAP Queue A item 6",
}


def refuse(feature: str) -> NoReturn:
    if feature in SUBCOMMANDS:
        raise NotImplementedError(
            f"the {feature!r} subcommand is not in the torch port yet "
            f"({SUBCOMMANDS[feature]})"
        )
    what, item = FEATURES[feature]
    raise NotImplementedError(f"{what} is not in the torch port yet ({item})")
