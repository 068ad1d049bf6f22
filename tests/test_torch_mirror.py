"""The torch port's serving mirror (``cluster/mirror.py``) on the CPU.

Parity: the JAX ``DeviceTreeMirror(sharding="off")`` and the port's
``DeviceTreeMirror(device="cpu")`` read one ``NativeEngine`` and are fed the
same seeded events — writes landing during the warm build, value updates,
inserts, deletes, a truncate and a refill. After each ``publish_now()`` both
serve the same stamped root, the same stamped ``TREELEVEL`` slices, the same
staleness and leaf count, and the root is ``NativeEngine.merkle_root()``.
The port's serving tree also counts ``device.scatter_keys`` and
``device.restructure_keys`` as the JAX state does for the same batches.

Port only, on an engine this file defines: on a CPU mirror a persistent
``scatter`` fault walks the ladder to the CPU rung with golden roots and
heals back; with the card's ladder (it ends at rung 1) the same fault only
invalidates and re-warms, never stepping down; a scatter that fails after it
wrote the levels never lets a stamped TREELEVEL row disagree with the
stamped root; a hang leaves the pump alive and queries unblocked; the scrub
catches an injected corruption and rebuilds; ``invalidate`` leaves one
fallback heartbeat; sharded modes, a missing GPU and a ladder with a CPU
rung on the card are refused at construction.

Tolerance everywhere: exact equality, digests bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

from merklekv_tpu.cluster.change_event import ChangeEvent as JaxEvent
from merklekv_tpu.cluster.change_event import OpKind as JaxOp
from merklekv_tpu.cluster.mirror import DeviceTreeMirror as JaxMirror
from merklekv_tpu.merkle.incremental import DeviceMerkleState as JaxState
from merklekv_tpu_torch.native_bindings import NativeEngine
from merklekv_tpu.obs.metrics import get_metrics as jax_metrics
from merklekv_tpu_torch.cluster import mirror as mirror_mod
from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind
from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
from merklekv_tpu_torch.cluster.retry import RetryPolicy
from merklekv_tpu_torch.device import guard as guard_mod
from merklekv_tpu_torch.device.guard import DispatchHungError
from merklekv_tpu_torch.device.ladder import DeviceBackendLadder
from merklekv_tpu_torch.merkle import incremental as incremental_mod
from merklekv_tpu_torch.merkle.cpu import build_levels, ref_level_sizes
from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.obs.metrics import get_metrics
from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector

CPU = "cpu"
EMPTY = "0" * 64


def _wait(cond, timeout=30.0, poll=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


@pytest.fixture(autouse=True)
def _guard_restored():
    """The guard and its injection slot are process-wide: put them back."""
    old = guard_mod.get_guard().deadline_ms
    yield
    guard_mod.set_inject(None)
    guard_mod.configure(deadline_ms=old)


# ------------------------------------------------------------ parity

class _Snapping:
    """A view of the engine that signals when a warm build has read its
    snapshot, so the test can land writes during that build."""

    def __init__(self, eng):
        self._eng = eng
        self.snapped = threading.Event()

    def version(self):
        return self._eng.version()

    def get(self, key):
        return self._eng.get(key)

    def snapshot(self):
        items = self._eng.snapshot()
        self.snapped.set()
        return items


def _events(ops):
    """(op, key bytes) -> the JAX and the port event lists."""
    jax_evs = [JaxEvent(op=JaxOp(op), key=k.decode(), val=None, ts=1, src="t") for op, k in ops]
    port_evs = [ChangeEvent(op=OpKind(op), key=k.decode(), val=None, ts=1, src="t")
                for op, k in ops]
    return jax_evs, port_evs


def _stage(jm, tm, eng, ops):
    """The replicator's order: the writes have landed, the version is read,
    then the drained events are staged on both mirrors."""
    wm = eng.version()
    jax_evs, port_evs = _events(ops)
    jm.on_events(jax_evs, watermark=wm)
    tm.on_events(port_evs, watermark=wm)


def _assert_parity(jm, tm, eng, rng, what, caught_up=True):
    """``caught_up=False`` after a warm with writes during the build: the
    stamp then stays at the snapshot's version (the watermark contract lets
    it understate) until the next staging, on both mirrors alike."""
    jm.publish_now()
    tm.publish_now()
    root = eng.merkle_root()
    want = root.hex() if root is not None else EMPTY
    ver = eng.version()
    stamped = tm.published_root_stamped()
    assert stamped == jm.published_root_stamped(), what
    assert tm.staleness() == jm.staleness() == ver - stamped[1], what
    assert stamped[0] == want, what
    if caught_up:
        assert stamped[1] == ver, what
    else:
        assert stamped[1] <= ver
        ver = stamped[1]
    n = jm.leaf_count()
    assert tm.leaf_count() == n == len(eng.snapshot()), what
    for level, m in enumerate(ref_level_sizes(n)):
        mid = int(rng.randint(0, m))
        for lo, hi in ((0, m), (m - 1, m), (mid, mid + 3), (0, m + 4)):
            got = tm.level_nodes_stamped(level, lo, hi)
            assert got == jm.level_nodes_stamped(level, lo, hi), (what, level, lo, hi)
            assert got[1:] == (n, ver), what


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_matches_jax_mirror_and_engine(seed):
    rng = np.random.RandomState(seed)
    keys = [b"mp:%03d" % i for i in range(60)]
    eng = NativeEngine()
    for k in keys[:40]:
        eng.set(k, b"v0-%d" % rng.randint(1000))
    jview, tview = _Snapping(eng), _Snapping(eng)
    jm = JaxMirror(jview, sharding="off", scrub_interval_s=0.0)
    tm = DeviceTreeMirror(tview, device=CPU, scrub_interval_s=0.0)
    try:
        jm.start_warming()
        tm.start_warming()
        assert jview.snapped.wait(60) and tview.snapped.wait(60)
        # Writes while the builds run: both mirrors record them and replay
        # them from the engine at swap-in.
        during = [keys[i] for i in rng.choice(40, size=5, replace=False)]
        for k in during:
            eng.set(k, b"warm-%d" % rng.randint(1000))
        _stage(jm, tm, eng, [("set", k) for k in during])
        assert _wait(lambda: jm.ready() and tm.ready(), timeout=120)
        assert tm.backend_level() == jm.backend_level() == 1
        _assert_parity(jm, tm, eng, rng, "warm", caught_up=False)

        live = set(keys[:40])
        for round_ in range(3):
            # Value updates of live keys.
            touched = sorted(rng.choice(sorted(live), size=8, replace=False))
            for k in touched:
                eng.set(k, b"r%d-%d" % (round_, rng.randint(1000)))
            _stage(jm, tm, eng, [("set", k) for k in touched])
            _assert_parity(jm, tm, eng, rng, f"values {round_}")
            # Inserts and deletes, with a value update in the same batch.
            ins = [k for k in keys if k not in live][:3]
            dels = sorted(rng.choice(sorted(live), size=3, replace=False))
            ops = []
            for k in ins:
                eng.set(k, b"i%d" % round_)
                live.add(k)
                ops.append(("set", k))
            for k in dels:
                eng.delete(k)
                live.discard(k)
                ops.append(("del", k))
            upd = sorted(live)[0]
            eng.set(upd, b"u%d" % round_)
            ops.append(("set", upd))
            _stage(jm, tm, eng, ops)
            _assert_parity(jm, tm, eng, rng, f"structure {round_}")

        # Truncate, with writes after it in the same drained batch, then a
        # refill.
        eng.truncate()
        eng.set(keys[0], b"after")
        _stage(jm, tm, eng, [("set", keys[5]), ("truncate", b""), ("set", keys[0])])
        _assert_parity(jm, tm, eng, rng, "truncate")
        refill = keys[10:30]
        for k in refill:
            eng.set(k, b"refill")
        _stage(jm, tm, eng, [("set", k) for k in refill])
        _assert_parity(jm, tm, eng, rng, "refill")
    finally:
        jm.close()
        tm.close()


def test_state_metrics_count_like_the_jax_state():
    names = ("device.scatter_keys", "device.restructure_keys")
    rng = np.random.RandomState(7)
    items = {b"sm:%03d" % i: b"v%d" % i for i in range(40)}
    port = DeviceMerkleState.from_items(items.items(), device=CPU)
    ref = JaxState.from_items(items.items())

    def counts(reg):
        c = reg.snapshot()["counters"]
        return [c.get(n, 0) for n in names]

    base_p, base_r = counts(get_metrics()), counts(jax_metrics())
    batches = [
        [(b"sm:%03d" % i, b"x%d" % i) for i in rng.choice(40, size=9, replace=False)],
        [(b"sm:%03d" % i, b"y") for i in (1, 2, 3)] + [(b"sm:new", b"n"), (b"sm:004", None)],
        [(b"sm:%03d" % i, None) for i in (10, 11)],
        [(b"sm:%03d" % i, b"z%d" % i) for i in rng.choice(30, size=12, replace=False)],
    ]
    for batch in batches:
        port.apply(batch)
        ref.apply(batch)
        assert port.root_hex() == ref.root_hex()
    got_p = [a - b for a, b in zip(counts(get_metrics()), base_p)]
    got_r = [a - b for a, b in zip(counts(jax_metrics()), base_r)]
    assert got_p == got_r and min(got_p) > 0
    assert get_metrics().snapshot()["counters"]["device.scatter_bytes"] > 0


# ------------------------------------------------------------ port only

class DictEngine:
    """A dict plus a mutation counter: the three calls the mirror reads."""

    def __init__(self, items=()):
        self._mu = threading.Lock()
        self._d = dict(items)
        self._v = len(self._d)
        self.snapshots = 0

    def set(self, key, value):
        with self._mu:
            self._d[key] = value
            self._v += 1

    def version(self):
        return self._v

    def get(self, key):
        return self._d.get(key)

    def snapshot(self):
        with self._mu:
            self.snapshots += 1
            return sorted(self._d.items())

    def golden(self):
        return CpuMerkleState.from_items(self.snapshot()).root_hex()


N_KEYS = 96
FAST_HEAL = RetryPolicy(first_delay=0.05, max_delay=0.2, jitter=0.0)


def _dict_mirror(degrade_after=2, heal=FAST_HEAL, cpu_rung=True, **kw):
    eng = DictEngine((b"lk:%04d" % i, b"v%d" % i) for i in range(N_KEYS))
    ladder = DeviceBackendLadder(0, degrade_after=degrade_after, heal_policy=heal,
                                 cpu_rung=cpu_rung)
    kw.setdefault("scrub_interval_s", 0.0)
    kw.setdefault("max_staleness_ms", 50.0)
    m = DeviceTreeMirror(eng, device=CPU, ladder=ladder, **kw)
    m.start_warming()
    assert _wait(m.ready), "mirror never warmed"
    return eng, m


def _write(eng, m, key, value):
    eng.set(key, value)
    m.on_events([ChangeEvent(OpKind.SET, key.decode(), None, 1, "t")],
                watermark=eng.version())


def _write_until_rewarmed(eng, m, i, value):
    """One write whose drain fails, then wait for the re-warm it owes."""
    r0 = _counter("device.rewarms")
    _write(eng, m, b"lk:%04d" % i, value)
    assert _wait(lambda: _counter("device.rewarms") > r0), "the drain did not fail"
    assert _wait(m.ready), "never re-warmed"


def _seq0():
    last = get_recorder().last(1)
    return last[-1].seq if last else 0


def test_scatter_fault_degrades_to_cpu_rung_then_heals():
    eng, m = _dict_mirror(heal=RetryPolicy(first_delay=1.0, max_delay=1.0, jitter=0.0))
    seq0 = _seq0()
    try:
        assert m.backend_level() == 1
        inj = DeviceFaultInjector(match="scatter", mode="fail").install()
        # Each failed drain invalidates and re-warms; the second in a row
        # steps the CPU mirror's ladder down.
        for i in range(2):
            _write_until_rewarmed(eng, m, i, b"FAULT")
        assert m.backend_level() == 0, "never stepped down"
        # The CPU rung serves golden roots (checked while it is still the
        # serving rung: the heal probe exercises no scatter and may climb).
        assert _wait(lambda: (m.publish_now(), m.backend_level() == 0
                              and m.published_root_stamped() == (eng.golden(), eng.version()))[1])
        evs = [e for e in get_recorder().last(0) if e.seq > seq0]
        deg = [e for e in evs if e.kind == "device_degraded"]
        assert deg and deg[0].fields["from_rung"] == 1 and deg[0].fields["to_rung"] == 0
        assert deg[0].fields["where"] == "drain" and inj.failures >= 2
        inj.heal()
        assert _wait(lambda: m.backend_level() == 1), "never climbed back"
        _write(eng, m, b"lk:0001", b"HEALED")
        m.publish_now()
        assert m.published_root_stamped() == (eng.golden(), eng.version())
        assert m.staleness() == 0
        assert any(e.kind == "device_healed" for e in get_recorder().last(0) if e.seq > seq0)
    finally:
        m.close()


# A plain-version dispatch on the CPU takes tens of milliseconds, so the
# deadlines here are wider than the card's.
HANG_DEADLINE_S = 1.0


def test_hang_keeps_pump_alive_and_queries_unblocked():
    eng, m = _dict_mirror(dispatch_deadline_ms=HANG_DEADLINE_S * 1e3)
    slowest = 0.0
    try:
        with DeviceFaultInjector(match="scatter", mode="hang") as inj:
            _write(eng, m, b"lk:0002", b"HUNG")
            t_end = time.monotonic() + 3 * HANG_DEADLINE_S
            while time.monotonic() < t_end:
                t0 = time.perf_counter()
                m.published_root_stamped()
                slowest = max(slowest, time.perf_counter() - t0)
                time.sleep(0.005)
            assert inj.hangs >= 1
            assert m._pump_thread is not None and m._pump_thread.is_alive()
            assert _counter("device.guard_timeouts") >= 1
            # The hung drain invalidated the state; its re-warm serves
            # the write.
            assert _wait(lambda: m.ready() and m.staleness() == 0)
            assert m.published_root_hex() == eng.golden()
        assert slowest < HANG_DEADLINE_S + 0.1, f"a query waited {slowest:.3f} s"
        assert _wait(lambda: m.backend_level() == 1)
        _write(eng, m, b"lk:0003", b"AFTER")
        m.publish_now()
        assert m.published_root_stamped() == (eng.golden(), eng.version())
        time.sleep(0.3 * HANG_DEADLINE_S)  # abandoned workers reach their lock
    finally:
        m.close()


def test_card_ladder_rewarms_and_never_steps_down():
    """The ladder a mirror on the card gets ends at rung 1: a persistent
    scatter fault invalidates and re-warms on the same rung, every time."""
    eng, m = _dict_mirror(degrade_after=1, cpu_rung=False)
    seq0 = _seq0()
    deg0, r0 = _counter("device.degraded_total"), _counter("device.rewarms")
    levels = set()
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            levels.add(m.backend_level())
            time.sleep(0.0005)

    t = threading.Thread(target=watch)
    t.start()
    try:
        with DeviceFaultInjector(match="scatter", mode="fail") as inj:
            for i in range(3):
                _write_until_rewarmed(eng, m, i, b"CARD")
                assert m.published_root_stamped() == (eng.golden(), eng.version())
                assert m.staleness() == 0
            assert inj.failures >= 3
        _write(eng, m, b"lk:0050", b"HEALED")
        m.publish_now()
        assert m.published_root_stamped() == (eng.golden(), eng.version())
    finally:
        stop.set()
        t.join(10)
        m.close()
    assert 0 not in levels and 1 in levels
    assert _counter("device.degraded_total") == deg0
    assert _counter("device.rewarms") >= r0 + 3
    evs = [e for e in get_recorder().last(0) if e.seq > seq0]
    assert not [e for e in evs if e.kind == "device_degraded"]
    rew = [e for e in evs if e.kind == "device_rewarm"]
    assert len(rew) >= 3 and all(e.fields["rung"] == 1 for e in rew)


def test_torn_scatter_never_serves_inconsistent_rows(monkeypatch):
    """A value scatter that wrote the levels in place and then failed: no
    stamped TREELEVEL read may disagree with the stamped root it rides
    with (the leaves must hash to it)."""
    real = incremental_mod.rehash_paths
    armed = threading.Event()

    def torn(*args, **kw):
        real(*args, **kw)
        if armed.is_set():
            raise RuntimeError("unable to initialize backend (scatter failed after writing)")

    monkeypatch.setattr(incremental_mod, "rehash_paths", torn)
    eng, m = _dict_mirror()
    bad, reads = [], [0]
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            with m._mu:
                snap = m.published_root_stamped()
                out = m.level_nodes_stamped(0, 0, N_KEYS)
            if snap is not None and out is not None:
                rows, _, ver = out
                reads[0] += 1
                root = build_levels([d for _, d in rows])[-1][0].hex()
                if ver != snap[1] or root != snap[0]:
                    bad.append((snap, ver))
            time.sleep(0.0002)

    t = threading.Thread(target=reader)
    t.start()
    try:
        armed.set()
        _write_until_rewarmed(eng, m, 7, b"TORN")
        time.sleep(0.2)
        armed.clear()
        _write(eng, m, b"lk:0008", b"AFTER")
        m.publish_now()
        assert m.published_root_stamped() == (eng.golden(), eng.version())
    finally:
        stop.set()
        t.join(10)
        m.close()
    assert reads[0] > 0 and not bad, bad[:3]


def test_abandoned_scatter_never_writes_late():
    """A value scatter that outlives its deadline must not land after the
    retry: it would overwrite a newer value in place."""
    guard_mod.configure(deadline_ms=HANG_DEADLINE_S * 1e3)
    st = DeviceMerkleState.from_items([(b"k%02d" % i, b"v") for i in range(8)], device=CPU)
    with DeviceFaultInjector(match="scatter", mode="hang", hang_s=1.5 * HANG_DEADLINE_S,
                             count=1):
        st.apply([(b"k03", b"old")])
        with pytest.raises(DispatchHungError):
            st.flush_pending()
        st.apply([(b"k03", b"new")])
        st.flush_pending()
    time.sleep(0.7 * HANG_DEADLINE_S)  # the abandoned worker wakes, finds itself cancelled
    want = CpuMerkleState.from_items(
        [(b"k%02d" % i, b"v") for i in range(8) if i != 3] + [(b"k03", b"new")])
    assert st.root_hex() == want.root_hex()
    assert st.level_nodes(0, 0, 8) == want.level_nodes(0, 0, 8)


def _counter(name):
    return get_metrics().snapshot()["counters"].get(name, 0)


def test_concurrent_writers_queries_and_pump_lose_no_update():
    """More writer threads than cores stage into one mirror while readers
    poll the served root and level slices and the pump drains, with a short
    switch interval: once every writer has staged, the published tree is
    the engine's, so no update was lost between staging, the pump, the
    dispatch lock and the in-place scatter."""
    import os
    import sys

    eng, m = _dict_mirror(max_staleness_ms=20.0)
    writers = 2 * (os.cpu_count() or 4)
    stop = threading.Event()
    errors = []

    def writer(w):
        rng = np.random.RandomState(w)
        try:
            for r in range(12):
                keys = [b"lk:%04d" % i for i in rng.choice(N_KEYS, size=6, replace=False)]
                for k in keys:
                    eng.set(k, b"w%d-%d" % (w, r))
                m.on_events([ChangeEvent(OpKind.SET, k.decode(), None, 1, "t") for k in keys],
                            watermark=eng.version())
        except BaseException as e:  # reported below
            errors.append(e)

    def reader():
        while not stop.is_set():
            try:
                m.published_root_stamped()
                m.level_nodes_stamped(0, 0, 8)
            except BaseException as e:
                errors.append(e)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader) for _ in range(2)]
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(writers)]
        for t in readers + threads:
            t.start()
        for t in threads:
            t.join(60)
        stop.set()
        for t in readers:
            t.join(60)
        assert not any(t.is_alive() for t in readers + threads), "a thread hung"
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors
        m.publish_now()
        assert m.published_root_stamped() == (eng.golden(), eng.version())
        assert m.staleness() == 0 and m.backend_level() == 1
        want = CpuMerkleState.from_items(eng.snapshot())
        assert m.level_nodes(0, 0, N_KEYS) == want.level_nodes(0, 0, N_KEYS)
    finally:
        m.close()


def test_scrub_catches_injected_corruption_and_rebuilds():
    base = _counter("device.scrub_mismatches")
    eng = DictEngine((b"lk:%04d" % i, b"v%d" % i) for i in range(N_KEYS))
    m = DeviceTreeMirror(eng, device=CPU, scrub_interval_s=0.0, max_staleness_ms=50.0,
                         ladder=DeviceBackendLadder(0, degrade_after=3, heal_policy=FAST_HEAL))
    try:
        with DeviceFaultInjector(match="build", mode="corrupt") as inj:
            m.start_warming()
            assert _wait(m.ready)
            assert inj.corruptions >= 1
            inj.heal()
            # The flipped leaf hides under a plausible root.
            assert m.published_root_hex() == eng.golden()
            m._scrub_keys = 1 << 20  # whole-keyspace sample: a sure hit
            assert m.scrub_once() is False, "scrub missed the flipped leaf"
        assert _counter("device.scrub_mismatches") == base + 1
        assert any(e.kind == "device_corruption" for e in get_recorder().last(50))
        assert _wait(lambda: m.ready() and m.scrub_once() is True)
        assert m.published_root_hex() == eng.golden()
        assert m.backend_level() == 1
    finally:
        m.close()


def test_invalidate_leaves_one_fallback_heartbeat():
    eng, m = _dict_mirror()
    try:
        def beats():
            return [e for e in get_recorder().last(0) if e.kind == "device_fallback"]

        base = len(beats())
        m.invalidate()
        m.pump_lag_ms()  # the gauge poll path
        m.pump_lag_ms()  # a second poll inside the window: no duplicate
        assert len(beats()) == base + 1
        assert beats()[-1].fields["rung"] == 1
        assert m.backend_level() == -1 and m.published_root_stamped() is None
        assert m.root_hex() == eng.golden()  # the exact path rebuilds
    finally:
        m.close()


@pytest.mark.parametrize("sharding", ["auto", "4", "8"])
def test_sharded_modes_raise(sharding):
    eng = DictEngine([(b"k", b"v")])
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        DeviceTreeMirror(eng, sharding=sharding, device=CPU)
    with pytest.raises(NotImplementedError):
        DeviceTreeMirror(eng, device=CPU, ladder=DeviceBackendLadder(int(sharding)
                                                                       if sharding != "auto" else 2))
    assert eng.snapshots == 0


def test_sharded_alias_raises_and_off_spellings_serve_one_device():
    eng = DictEngine([(b"k", b"v")])
    with pytest.raises(NotImplementedError):
        DeviceTreeMirror(eng, sharded=True, device=CPU)
    for mode in ("off", "OFF", "0", "none", "1"):
        m = DeviceTreeMirror(eng, sharding=mode, device=CPU, scrub_interval_s=0.0)
        try:
            assert m.root_hex() == eng.golden() and m.backend_level() == 1
        finally:
            m.close()


def test_card_mirror_ladder_has_no_cpu_rung(monkeypatch):
    """A mirror resolved onto the card builds a ladder ending at rung 1 and
    refuses one with a CPU rung; nothing is built to find that out."""
    monkeypatch.setattr(mirror_mod, "resolve_device", lambda device: torch.device("cuda", 0))
    eng = DictEngine([(b"k", b"v")])
    with pytest.raises(ValueError, match="cpu_rung=False"):
        DeviceTreeMirror(eng, ladder=DeviceBackendLadder(0))
    m = DeviceTreeMirror(eng, ladder=DeviceBackendLadder(0, cpu_rung=False))
    assert m.ladder.bottom() == 1
    m = DeviceTreeMirror(eng, scrub_interval_s=0.0)
    lad = m._ensure_ladder()
    assert lad.current() == lad.bottom() == 1 and lad.at_bottom()
    assert eng.snapshots == 0


def test_no_gpu_raises_before_any_ladder(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-GPU behaviour is not observable")
    built = []
    monkeypatch.setattr(mirror_mod, "DeviceBackendLadder",
                        lambda *a, **kw: built.append(a) or DeviceBackendLadder(*a, **kw))
    eng = DictEngine([(b"k", b"v")])
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTreeMirror(eng)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTreeMirror(eng, device="cuda")
    assert built == [] and eng.snapshots == 0
