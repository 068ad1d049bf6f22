"""Convergence-lag SLO plane: per-peer replication lag + readiness.

A copy of ``merklekv_tpu/obs/lag.py``, its imports pointed at the port's modules.

The TRACE verb answered "what is this node doing"; nothing answered **"how stale is
replica B relative to A right now?"**. This module derives that from the
publish high-water mark each replication envelope now carries
(``hseq`` = the publisher's cumulative events put on the wire including
the frame, ``hts`` = its publish wall clock — change_event.py):

- ``replication.lag_events{src}``: events the peer has published that this
  node has not yet applied — ``seen hseq − accounted``. Grows while frames
  are held (bootstrap) or lost (QoS-0 drop); returns to 0 when applies
  catch up, and a **full clean anti-entropy pass** — every configured
  peer synced this round with nothing checkpointed, degraded, or skipped
  — clears any drop residue via
  :meth:`ConvergenceTracker.on_converged`, because the repair (root
  comparison against the whole peer set), not a frame, is what converged
  the data. A single pairwise cycle never clears residue: converging with
  peer A proves nothing about events a partitioned peer B published.
- ``replication.lag_ms{src}``: publish→apply wall delay of the newest
  applied frame from the peer (cross-host clock skew applies — the usual
  wall-clock caveat).
- ``replication.convergence`` histogram (seconds): write-origin → applied
  HERE, observed once per applied frame at its oldest event. Each replica
  observes its own copy; "write → ALL replicas applied" is the max of
  this family across instances (PromQL ``max()``), so the SLO needs no
  global coordinator.

Readiness (``/healthz`` and the METRICS block) folds the above into one
level:

- ``diverged`` — some peer's lag residue has persisted longer than
  ``diverged_after_s`` with no anti-entropy convergence clearing it;
- ``lagging``  — residue exists (applies behind / frames held), or the
  last applied frame arrived more than ``lag_ms_threshold`` behind its
  publish clock within the recent window;
- ``live``     — neither.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from merklekv_tpu_torch.obs.metrics import get_metrics

__all__ = ["ConvergenceTracker", "PeerLag", "READINESS_CODES"]

# The ONE readiness-level <-> numeric-code mapping (gauge value, METRICS
# readiness_code line, top's rendering all derive from it).
READINESS_CODES = {"live": 2, "lagging": 1, "diverged": 0}

# How long a high last-observed apply delay keeps readiness at "lagging"
# after the apply: an idle, converged node must not stay lagging forever
# because its final frame once crossed a slow link.
_RECENT_APPLY_S = 60.0


@dataclass
class PeerLag:
    """Per-publisher (``src`` node id) lag accounting."""

    seen_hseq: int = 0  # newest publish HWM seen from the peer
    accounted: int = 0  # events applied (or baselined away at first sight)
    last_hts_ns: int = 0  # publish clock of the newest frame seen
    last_apply_unix: float = 0.0
    last_apply_lag_ms: float = 0.0
    # When the residue (seen - accounted) last became nonzero; 0 = none.
    lag_since_unix: float = 0.0
    baselined: bool = field(default=False, repr=False)


class ConvergenceTracker:
    """Thread-safe per-peer lag state feeding the gauges + readiness."""

    def __init__(
        self,
        lag_ms_threshold: float = 1000.0,
        diverged_after_s: float = 120.0,
    ) -> None:
        self._mu = threading.Lock()
        self._peers: dict[str, PeerLag] = {}
        self.lag_ms_threshold = lag_ms_threshold
        self.diverged_after_s = diverged_after_s

    # -- ingest ----------------------------------------------------------------
    def on_frame(
        self, src: str, n_events: int, hseq: int = 0, hts_ns: int = 0
    ) -> None:
        """An envelope from ``src`` decoded (apply may still be deferred).
        A peer first seen mid-stream is baselined to this frame — events it
        published before we subscribed are anti-entropy's job, not lag."""
        if not src or hseq <= 0:
            return  # legacy frame without a HWM: nothing to account
        with self._mu:
            st = self._peers.setdefault(src, PeerLag())
            if not st.baselined:
                st.baselined = True
                st.accounted = max(0, hseq - n_events)
            if hseq > st.seen_hseq:
                st.seen_hseq = hseq
            if hts_ns > st.last_hts_ns:
                st.last_hts_ns = hts_ns
            if st.seen_hseq > st.accounted and st.lag_since_unix == 0.0:
                st.lag_since_unix = time.time()

    def on_applied(
        self,
        src: str,
        n_events: int,
        hts_ns: int = 0,
        oldest_event_ts_ns: int = 0,
    ) -> None:
        """A frame from ``src`` fully applied (live or bootstrap replay)."""
        now = time.time()
        now_ns = time.time_ns()
        with self._mu:
            st = self._peers.setdefault(src, PeerLag())
            st.accounted += n_events
            if st.accounted > st.seen_hseq:
                # Legacy frames (no HWM) can over-account; raise the
                # watermark to match so the residue math stays >= 0.
                st.seen_hseq = st.accounted
            st.last_apply_unix = now
            if hts_ns > 0:
                st.last_apply_lag_ms = max(0.0, (now_ns - hts_ns) / 1e6)
            if st.accounted >= st.seen_hseq:
                st.lag_since_unix = 0.0
        if oldest_event_ts_ns > 0:
            # Write-origin -> applied-here; per-frame at its oldest event.
            get_metrics().observe(
                "replication.convergence",
                max(0.0, (now_ns - oldest_event_ts_ns) / 1e9),
            )

    def on_converged(self) -> None:
        """A FULL CLEAN anti-entropy pass (every configured peer, nothing
        checkpointed/degraded/skipped — the periodic loop's verdict)
        proved or restored convergence by root comparison: whatever
        residue dropped frames left behind is repaired data now, so the
        counters stop reporting it as lag."""
        with self._mu:
            for st in self._peers.values():
                st.accounted = st.seen_hseq
                st.lag_since_unix = 0.0

    # -- read ------------------------------------------------------------------
    def lag_events(self) -> dict[str, int]:
        with self._mu:
            return {
                src: max(0, st.seen_hseq - st.accounted)
                for src, st in self._peers.items()
            }

    def lag_ms(self) -> dict[str, float]:
        with self._mu:
            return {
                src: round(st.last_apply_lag_ms, 3)
                for src, st in self._peers.items()
            }

    def readiness(self) -> str:
        now = time.time()
        with self._mu:
            worst = "live"
            for st in self._peers.values():
                if st.seen_hseq > st.accounted:
                    since = st.lag_since_unix or now
                    if now - since > self.diverged_after_s:
                        return "diverged"
                    worst = "lagging"
                elif (
                    st.last_apply_lag_ms > self.lag_ms_threshold
                    and now - st.last_apply_unix < _RECENT_APPLY_S
                ):
                    worst = "lagging"
            return worst

    def readiness_code(self) -> int:
        return READINESS_CODES.get(self.readiness(), -1)

    def snapshot(self) -> dict[str, PeerLag]:
        with self._mu:
            return {src: PeerLag(**vars(st)) for src, st in self._peers.items()}
