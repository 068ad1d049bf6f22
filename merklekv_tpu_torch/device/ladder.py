"""Degradation ladder: degrade instead of the all-or-nothing cliff to the
native fallback (copy of ``merklekv_tpu/device/ladder.py``:
``rung_sequence`` and ``DeviceBackendLadder``, with a torch
``build_state_for_rung``, and a ladder and ``build_state_with_ladder`` that
can end at rung 1).

Rungs, top to bottom, for a resolved shard width N:

    sharded(N) -> sharded(N/2) -> ... -> sharded(2) -> single device -> CPU

Every rung answers **bit-identically** (the CPU golden tree IS the
reference tree), so stepping down sheds throughput — never correctness,
never the wire contract. Rung values double as the ``device.backend_level``
gauge code: N>=2 sharded width, 1 single device, 0 CPU golden (the mirror
reports -1 while nothing is built).

Rungs >= 2 are ``parallel/sharded_state.py::ShardedDeviceMerkleState``
over the first N of the caller's devices, rung 1 is one device
(``merkle/incremental.py``), rung 0 the CPU golden tree
(``merkle/cpu_state.py``). A ladder built with ``cpu_rung=False`` ends at
rung 1: a mirror on the card uses it, so its work never moves to the host
(a sharded rung that fails steps down to N/2 ... 1, all on the card), while
a mirror built on the CPU keeps the JAX package's full ladder.
``build_state_with_ladder`` follows the same rule: on the card it ends at
rung 1 and raises when every rung fails (the JAX function cannot fail,
since its CPU rung cannot); when every device it is given is the CPU it
ends at rung 0.

Policy:

- ``note_failure`` counts CONSECUTIVE guarded-dispatch failures at the
  current rung and steps down after ``degrade_after`` of them (build
  failures step immediately). Each step records a ``device_degraded``
  flight event carrying the classified kind.
- While degraded, a background **re-warm probe** (driven by the mirror's
  pump) climbs back up under ``retry.DEVICE_HEAL`` escalating backoff. The
  probe targets the TOP rung first and walks its target down one rung per
  failed probe before wrapping. A successful probe climbs and records
  ``device_healed``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

import torch

from merklekv_tpu_torch.cluster.retry import DEVICE_HEAL, RetryPolicy
from merklekv_tpu_torch.obs.metrics import get_metrics

__all__ = [
    "DeviceBackendLadder",
    "rung_sequence",
    "build_state_for_rung",
    "build_state_with_ladder",
]


def rung_sequence(top_shards: int) -> list[int]:
    """Descending rung values for a resolved top shard width (0/1 both
    mean a single-device top)."""
    rungs: list[int] = []
    d = int(top_shards)
    while d >= 2:
        rungs.append(d)
        d //= 2
    rungs.extend([1, 0])
    return rungs


def build_state_for_rung(rung: int, items: Iterable, device=None, devices=None):
    """State factory shared by the mirror's warm path and its heal probe:
    >= 2 sharded over the first ``rung`` of ``devices`` (default: every
    card of the host), 1 single device (``device``, ``None`` = CUDA), 0 CPU
    golden."""
    if rung >= 2:
        from merklekv_tpu_torch.parallel.sharded_state import ShardedDeviceMerkleState

        return ShardedDeviceMerkleState.from_items(items, shards=rung, devices=devices)
    if rung == 1:
        from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState

        return DeviceMerkleState.from_items(items, device=device)
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState

    return CpuMerkleState.from_items(items)


def build_state_with_ladder(
    items,
    top_shards: int,
    devices=None,
    on_step: Optional[Callable[[int, BaseException], None]] = None,
):
    """Build a serving state at the highest rung that works, walking the
    ladder down on failure. Returns ``(state, rung)``; ``on_step(rung,
    exc)`` is called for every rung that failed.

    Rung N >= 2 shards over the first N of ``devices`` (default: every card
    of the host), rung 1 runs on the first of them (default: CUDA). When
    every device is the CPU the ladder ends at rung 0, the CPU golden tree,
    which cannot fail, as in the JAX function. Otherwise it ends at rung 1,
    so the work never moves to the host, and the error of rung 1 is raised
    when it fails too."""
    items = list(items)
    seq = rung_sequence(top_shards)
    if devices is None or any(torch.device(d).type != "cpu" for d in devices):
        seq.pop()
    device = None if devices is None else devices[0]
    last: Optional[Exception] = None
    for rung in seq:
        try:
            return (
                build_state_for_rung(rung, items, device=device, devices=devices),
                rung,
            )
        except Exception as e:
            last = e
            if on_step is not None:
                on_step(rung, e)
    raise last


class DeviceBackendLadder:
    def __init__(
        self,
        top_shards: int = 0,
        degrade_after: int = 2,
        heal_policy: RetryPolicy = DEVICE_HEAL,
        cpu_rung: bool = True,
    ) -> None:
        self._mu = threading.Lock()
        self._rungs = rung_sequence(top_shards)
        if not cpu_rung:
            self._rungs.pop()  # end at rung 1: never step down to the host
        self._degrade_after = max(1, int(degrade_after))
        self._heal_policy = heal_policy
        self._idx = 0
        self._fails = 0
        # Corruption failures count separately and survive note_success:
        # a corrupting rung DISPATCHES fine (every drain "succeeds"), so
        # the consecutive-failure reset would otherwise erase the count
        # between scrub detections and the rung could never step down.
        self._corrupt_fails = 0
        self._probe_idx = 0  # rung index the next heal probe targets
        self._probe_pinned: Optional[int] = None  # index handed out by probe_target
        self._heal_attempts = 0
        self._heal_next_m = 0.0

    # -- views ---------------------------------------------------------------
    def current(self) -> int:
        """Value of the current rung (lock-free int read — also the
        ``device.backend_level`` code while a state is serving)."""
        return self._rungs[self._idx]

    def degraded(self) -> bool:
        return self._idx > 0

    def at_bottom(self) -> bool:
        return self._idx == len(self._rungs) - 1

    def bottom(self) -> int:
        """Value of the lowest rung: 0 (CPU golden) or, for a ladder built
        with ``cpu_rung=False``, 1."""
        return self._rungs[-1]

    # -- failure accounting --------------------------------------------------
    def note_success(self) -> None:
        """A guarded dispatch (or drain) completed at the current rung."""
        with self._mu:
            self._fails = 0

    def note_failure(
        self, kind: str, where: str, immediate: bool = False
    ) -> bool:
        """Count one failure at the current rung; True when the ladder
        stepped down (the caller then rebuilds at ``current()``)."""
        with self._mu:
            if kind == "corruption":
                self._corrupt_fails += 1
                count = self._corrupt_fails
            else:
                self._fails += 1
                count = self._fails
            if not immediate and count < self._degrade_after:
                return False
            if self._idx >= len(self._rungs) - 1:
                self._fails = 0
                self._corrupt_fails = 0
                return False  # already on the bottom rung
            prev = self._rungs[self._idx]
            self._idx += 1
            cur = self._rungs[self._idx]
            self._fails = 0
            self._corrupt_fails = 0
            # Arm the heal probe: top-first, first attempt after one
            # backoff step.
            self._probe_idx = 0
            self._heal_attempts = 0
            self._heal_next_m = time.monotonic() + self._heal_policy.backoff(
                0
            )
        get_metrics().inc("device.degraded_total")
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            record(
                "device_degraded",
                from_rung=prev,
                to_rung=cur,
                kind=kind,
                where=where,
            )
        except Exception:
            pass
        return True

    # -- heal probing ----------------------------------------------------------
    def heal_due(self) -> bool:
        with self._mu:
            return self._idx > 0 and time.monotonic() >= self._heal_next_m

    def probe_target(self) -> int:
        """Rung value the next probe should exercise (top-first, walking
        down toward current+1 across failed probes). PINS the handed-out
        index: the probe builds while the pump may step the ladder down
        concurrently, and ``note_probe`` must credit the rung that was
        ACTUALLY probed."""
        with self._mu:
            idx = min(self._probe_idx, self._idx - 1)
            self._probe_pinned = idx
            return self._rungs[idx]

    def note_probe(self, ok: bool) -> Optional[int]:
        """Record a probe outcome. On success the ladder CLIMBS to the
        probed rung and returns its value (the caller re-warms there);
        on failure returns None and the next probe is scheduled lower /
        later."""
        get_metrics().inc("device.heal_probes")
        with self._mu:
            target_idx, self._probe_pinned = (
                self._probe_pinned
                if self._probe_pinned is not None
                else min(self._probe_idx, self._idx - 1)
            ), None
            if target_idx >= self._idx:
                # The ladder moved to (or past) the probed rung while the
                # probe ran — there is nothing to climb to.
                return None
            if not ok:
                self._heal_attempts += 1
                self._probe_idx = target_idx + 1
                if self._probe_idx >= self._idx:
                    self._probe_idx = 0  # wrap: retry the top next round
                self._heal_next_m = (
                    time.monotonic()
                    + self._heal_policy.backoff(self._heal_attempts)
                )
                return None
            prev = self._rungs[self._idx]
            self._idx = target_idx
            cur = self._rungs[self._idx]
            self._fails = 0
            self._corrupt_fails = 0
            self._probe_idx = 0
            self._heal_attempts = 0
            # Still degraded (partial heal): keep probing upward promptly.
            self._heal_next_m = time.monotonic() + self._heal_policy.backoff(
                0
            )
        get_metrics().inc("device.healed_total")
        try:
            from merklekv_tpu_torch.obs.flightrec import record

            record("device_healed", from_rung=prev, to_rung=cur)
        except Exception:
            pass
        return cur
