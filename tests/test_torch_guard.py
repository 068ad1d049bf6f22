"""The torch port's dispatch guard, fault injector and degradation ladder.

Against the JAX package: the same failure messages get the same
environment|code verdict from both classifiers, both ``rung_sequence``s
agree, and the same scripted sequence of ``note_failure`` / ``note_success``
/ ``probe_target`` / ``note_probe`` drives both ladders through the same
rungs with the same flight events (kinds and fields).

Port only: the guard and injector cases of the JAX package's unit layer
(deadline abandonment, retry once, code errors never retried, nested inline
calls, fail/hang/corrupt injection, the ``MKV_DEVICE_FAULTS`` spec, the
guard's counters), the ladder's policy, the card's ladder ending at rung 1,
and the CPU golden rung.
"""

import threading
import time

import pytest
import torch

from merklekv_tpu.cluster.retry import RetryPolicy as JaxRetryPolicy
from merklekv_tpu.device.ladder import DeviceBackendLadder as JaxLadder
from merklekv_tpu.device.ladder import rung_sequence as jax_rung_sequence
from merklekv_tpu.obs.flightrec import get_recorder as jax_recorder
from merklekv_tpu.utils import errorkind as jax_errorkind
from merklekv_tpu_torch.cluster.retry import RetryPolicy
from merklekv_tpu_torch.device import guard as guard_mod
from merklekv_tpu_torch.device.guard import (
    DeviceDispatchError,
    DispatchGuard,
    DispatchHungError,
)
from merklekv_tpu_torch.device.ladder import (
    DeviceBackendLadder,
    build_state_for_rung,
    rung_sequence,
)
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.obs.metrics import get_metrics
from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector
from merklekv_tpu_torch.utils import errorkind
from merklekv_tpu_torch.utils.errorkind import CODE, ENVIRONMENT

FAST = RetryPolicy(first_delay=0.01, max_delay=0.02, jitter=0.0, attempts=2)
JAX_FAST = JaxRetryPolicy(first_delay=0.01, max_delay=0.02, jitter=0.0, attempts=2)


# ------------------------------------------------------------ against JAX

MESSAGES = [
    "RuntimeError: need 8 devices, have 1",
    "mesh needs 4 devices",
    "no device found",
    "unable to initialize backend 'tpu'",
    "backend 'cuda' requested, but it failed",
    "failed to connect to all addresses",
    "TPU is already in use by another process",
    "DEADLINE_EXCEEDED: rpc timed out",
    "watchdog: 240s deadline expired in phase 'mesh-init'",
    "device dispatch 'scatter' failed: dispatch deadline 500ms expired",
    "socket closed",
    "connection reset by peer",
    "broken pipe",
    "AssertionError: sharded root != single-device root",
    "ValueError: shapes (8, 8) and (4, 8) are incompatible",
    "KeyError: b'missing'",
    "RuntimeError: CUDA error: an illegal memory access was encountered",
    "CUDA kernel path_rehash failed to launch: invalid configuration argument (9)",
    "torch.OutOfMemoryError: CUDA out of memory",
    "XlaRuntimeError: RESOURCE_EXHAUSTED: out of memory",
    "the timeout parameter must be positive",
]


@pytest.mark.parametrize("msg", MESSAGES)
def test_classify_error_matches_jax(msg):
    assert errorkind.classify_error(msg) == jax_errorkind.classify_error(msg)


@pytest.mark.parametrize("exc", [
    OSError("whatever"), TimeoutError(), ConnectionResetError("x"),
    ValueError("bad shape"), RuntimeError("unable to initialize backend"),
    RuntimeError("CUDA error: misaligned address"), KeyError("k"),
], ids=lambda e: f"{type(e).__name__}:{e}")
def test_classify_exception_matches_jax(exc):
    assert errorkind.classify_exception(exc) == jax_errorkind.classify_exception(exc)


def test_cuda_errors_read_as_code():
    """The port does not extend the table: a CUDA error with no matching
    text is a code error, as an unknown XLA error is."""
    assert errorkind.classify_error("CUDA error: an illegal memory access") == CODE


@pytest.mark.parametrize("top", [0, 1, 2, 4, 8])
def test_rung_sequence_matches_jax(top):
    assert rung_sequence(top) == jax_rung_sequence(top)


# Each step: (op, args). "sleep" waits out the heal backoff (jitter 0).
LADDER_SCRIPTS = {
    "drain_then_probe_top_first": (8, 2, [
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_success", ()),
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_failure", (CODE, "build", True)),
        ("note_failure", (ENVIRONMENT, "build", True)),
        ("heal_due", ()),
        ("sleep", ()),
        ("heal_due", ()),
        ("probe_target", ()),
        ("note_probe", (False,)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_probe", (False,)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_probe", (True,)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_probe", (True,)),
    ]),
    "single_device_to_cpu_and_back": (0, 2, [
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_failure", (ENVIRONMENT, "build", True)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_probe", (False,)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_probe", (True,)),
        ("note_probe", (True,)),
    ]),
    "corruption_counts_survive_success": (2, 2, [
        ("note_failure", ("corruption", "scrub", False)),
        ("note_success", ()),
        ("note_failure", ("corruption", "scrub", False)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_failure", (ENVIRONMENT, "drain", False)),
        ("note_probe", (True,)),
        ("sleep", ()),
        ("probe_target", ()),
        ("note_probe", (True,)),
    ]),
}


def _run_step(ladder, op, args):
    if op == "sleep":
        time.sleep(0.05)
        return None
    return getattr(ladder, op)(*args)


def _events_since(recorder, seq0):
    return [(e.kind, dict(e.fields)) for e in recorder.last(0) if e.seq > seq0]


def _last_seq(recorder):
    evs = recorder.last(1)
    return evs[-1].seq if evs else 0


@pytest.mark.parametrize("script", sorted(LADDER_SCRIPTS))
def test_ladder_decisions_match_jax(script):
    top, degrade_after, steps = LADDER_SCRIPTS[script]
    port = DeviceBackendLadder(top, degrade_after=degrade_after, heal_policy=FAST)
    ref = JaxLadder(top, degrade_after=degrade_after, heal_policy=JAX_FAST)
    seq_p, seq_r = _last_seq(get_recorder()), _last_seq(jax_recorder())
    trace_p, trace_r = [], []
    for op, args in steps:
        trace_p.append((op, _run_step(port, op, args), port.current(), port.degraded()))
        trace_r.append((op, _run_step(ref, op, args), ref.current(), ref.degraded()))
    assert trace_p == trace_r
    events = _events_since(get_recorder(), seq_p)
    assert events == _events_since(jax_recorder(), seq_r)
    assert {kind for kind, _ in events} >= {"device_degraded", "device_healed"}


# ------------------------------------------------------------ port only

def _counter(name):
    return get_metrics().snapshot()["counters"].get(name, 0)


def case_passthrough_and_deadline_abandonment():
    g = DispatchGuard(deadline_ms=300, policy=FAST)
    assert g.run("t", lambda: 41 + 1) == 42
    t0 = time.monotonic()
    with pytest.raises(DispatchHungError) as ei:
        g.run("t", lambda: time.sleep(3))
    assert time.monotonic() - t0 < 2.0, "guard waited past its deadline"
    assert ei.value.kind == ENVIRONMENT
    assert g.run("t", lambda: 7) == 7  # a fresh worker serves the next call


def case_retries_environment_once_then_raises_typed():
    g = DispatchGuard(deadline_ms=0, policy=FAST)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("unable to initialize backend (blip)")
        return "ok"

    assert g.run("t", flaky) == "ok"
    assert calls["n"] == 2
    calls["n"] = 0

    def dead():
        calls["n"] += 1
        raise RuntimeError("unable to initialize backend (persistent)")

    with pytest.raises(DeviceDispatchError) as ei:
        g.run("t", dead)
    assert calls["n"] == 2
    assert ei.value.kind == ENVIRONMENT and ei.value.label == "t"


def case_code_errors_never_retry():
    g = DispatchGuard(deadline_ms=0, policy=FAST)
    calls = {"n": 0}

    def buggy():
        calls["n"] += 1
        raise ValueError("scatter index shape mismatch")

    with pytest.raises(DeviceDispatchError) as ei:
        g.run("t", buggy)
    assert calls["n"] == 1 and ei.value.kind == CODE


def case_nested_call_runs_inline_no_false_hang():
    g = DispatchGuard(deadline_ms=500, policy=FAST)
    names = []

    def inner():
        names.append(threading.current_thread().name)
        return 5

    assert g.run("outer", lambda: g.run("inner", inner)) == 5
    assert names == [guard_mod.GUARD_THREAD_NAME]


def case_injector_fail_nth_and_count():
    inj = DeviceFaultInjector(match="scatter", at=2, count=1)
    g = DispatchGuard(deadline_ms=0, policy=FAST)
    with inj:
        assert g.run("scatter", lambda: 1) == 1   # matched #1: below at
        # matched #2 fails, #3 (the guard's retry) passes.
        assert g.run("scatter", lambda: 2) == 2
        assert inj.failures == 1
        assert g.run("build", lambda: 3) == 3     # label not matched


def case_injector_persistent_until_heal():
    inj = DeviceFaultInjector(match="scatter", mode="fail")
    g = DispatchGuard(deadline_ms=0, policy=FAST)
    with inj:
        with pytest.raises(DeviceDispatchError) as ei:
            g.run("scatter", lambda: 1)
        assert ei.value.kind == ENVIRONMENT
        assert g.run("build", lambda: 1) == 1
        inj.heal()
        assert g.run("scatter", lambda: 1) == 1
        inj.unheal()
        with pytest.raises(DeviceDispatchError):
            g.run("scatter", lambda: 1)


def case_injector_hang_exercises_abandonment():
    inj = DeviceFaultInjector(match="*", mode="hang", hang_s=2.0)
    g = DispatchGuard(deadline_ms=200, policy=FAST)
    with inj:
        t0 = time.monotonic()
        with pytest.raises(DispatchHungError):
            g.run("build", lambda: 1)
        assert time.monotonic() - t0 < 1.5
        assert inj.hangs == 1
    assert g.run("build", lambda: 1) == 1


def case_injector_hang_sized_off_the_live_deadline():
    old = guard_mod.get_guard().deadline_ms
    try:
        guard_mod.configure(deadline_ms=80)
        assert DeviceFaultInjector(mode="hang")._hang_duration_s() == pytest.approx(0.1)
        guard_mod.configure(deadline_ms=0)
        assert DeviceFaultInjector(mode="hang")._hang_duration_s() == 30.0
    finally:
        guard_mod.configure(deadline_ms=old)


def case_injector_corrupt_flips_leaf_zero_of_a_level_list():
    leaves = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    top = torch.ones((1, 8), dtype=torch.int32)
    g = DispatchGuard(deadline_ms=0, policy=FAST)
    with DeviceFaultInjector(match="build", mode="corrupt") as inj:
        out = g.run("build", lambda: [leaves, top])
        assert isinstance(out, list) and len(out) == 2
        assert int(out[0][0, 0]) == 1 and torch.equal(out[0][1:], leaves[1:])
        assert int(leaves[0, 0]) == 0, "the dispatch's own tensor was written"
        assert out[1] is top
        # Anything that is not a list of tensors passes through untouched.
        assert g.run("build", lambda: leaves) is leaves
        assert g.run("build", lambda: [(0, b"x")]) == [(0, b"x")]
        assert inj.corruptions == 3


def case_injector_env_spec_roundtrip():
    inj = DeviceFaultInjector.from_spec("fail:scatter:3")
    assert inj._match == "scatter" and inj._mode == "fail" and inj._at == 3
    with pytest.raises(ValueError):
        DeviceFaultInjector.from_spec("fail")
    with pytest.raises(ValueError):
        DeviceFaultInjector(mode="explode")


def case_env_var_arms_the_port_guard():
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MKV_DEVICE_FAULTS", "fail:scatter")
        mp.setattr(guard_mod, "_inject", None)
        mp.setattr(guard_mod, "_env_checked", False)
        inj = guard_mod.get_inject()
        assert isinstance(inj, DeviceFaultInjector) and inj._match == "scatter"
        with pytest.raises(DeviceDispatchError):
            DispatchGuard(deadline_ms=0, policy=FAST).run("scatter", lambda: 1)
    finally:
        mp.undo()


def case_guard_counts_timeouts_retries_and_errors():
    base = {n: _counter(n) for n in
            ("device.guard_timeouts", "device.guard_retries", "device.guard_errors")}
    g = DispatchGuard(deadline_ms=150, policy=FAST)
    with pytest.raises(DispatchHungError):
        g.run("t", lambda: time.sleep(1.5))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("connection reset by peer")
        return 1

    assert g.run("t", flaky) == 1
    with pytest.raises(DeviceDispatchError):
        g.run("t", lambda: 1 // 0)
    assert _counter("device.guard_timeouts") == base["device.guard_timeouts"] + 1
    assert _counter("device.guard_retries") == base["device.guard_retries"] + 1
    assert _counter("device.guard_errors") == base["device.guard_errors"] + 1


def case_ladder_degrade_threshold_and_immediate():
    lad = DeviceBackendLadder(8, degrade_after=2, heal_policy=FAST)
    assert lad.current() == 8 and not lad.degraded()
    assert not lad.note_failure(ENVIRONMENT, "drain")
    assert lad.note_failure(ENVIRONMENT, "drain")
    assert lad.current() == 4 and lad.degraded()
    assert not lad.note_failure(ENVIRONMENT, "drain")
    lad.note_success()
    assert not lad.note_failure(ENVIRONMENT, "drain")
    assert lad.note_failure(ENVIRONMENT, "build", immediate=True)
    assert lad.current() == 2
    assert lad.note_failure(ENVIRONMENT, "build", immediate=True)
    assert lad.note_failure(ENVIRONMENT, "build", immediate=True)
    assert lad.current() == 0 and lad.at_bottom()
    assert not lad.note_failure(ENVIRONMENT, "build", immediate=True)


def case_ladder_records_flight_events_and_counters():
    base_deg, base_heal = _counter("device.degraded_total"), _counter("device.healed_total")
    lad = DeviceBackendLadder(0, degrade_after=1, heal_policy=FAST)
    lad.note_failure(ENVIRONMENT, "drain")
    time.sleep(0.03)
    assert lad.heal_due() and lad.probe_target() == 1
    assert lad.note_probe(True) == 1
    evs = get_recorder().last(10)
    deg = [e for e in evs if e.kind == "device_degraded"][-1]
    assert deg.fields == {"from_rung": 1, "to_rung": 0, "kind": ENVIRONMENT, "where": "drain"}
    assert [e for e in evs if e.kind == "device_healed"][-1].fields == {"from_rung": 0, "to_rung": 1}
    assert _counter("device.degraded_total") == base_deg + 1
    assert _counter("device.healed_total") == base_heal + 1


def case_sharded_rungs_build_the_sharded_state():
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState

    items = [(b"k%d" % i, b"v") for i in range(5)]
    golden = CpuMerkleState.from_items(items).root_hex()
    for rung in (2, 4):
        st = build_state_for_rung(rung, items, device="cpu", devices=["cpu"] * 4)
        assert type(st).__name__ == "ShardedDeviceMerkleState" and st._n_shards == rung
        assert st.root_hex() == golden
    st = build_state_for_rung(1, items, device="cpu")
    assert type(st).__name__ == "DeviceMerkleState" and st.root_hex() == golden


def case_ladder_steps_to_cpu_rung_on_a_failing_build():
    """A CPU mirror's build steps 1 -> 0 at once on a failed build."""
    from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror

    class Eng:
        def version(self):
            return 0

        def get(self, key):
            return None

        def snapshot(self):
            return []

    base = _counter("device.degraded_total")
    m = DeviceTreeMirror(Eng(), device="cpu", scrub_interval_s=0.0)
    try:
        with DeviceFaultInjector(match="build", mode="fail"):
            st = m._build_state([(b"k%d" % i, b"v") for i in range(5)])
        assert st._n_shards == 0 and m.ladder.current() == 0
        assert _counter("device.degraded_total") == base + 1
        deg = [e for e in get_recorder().last(10) if e.kind == "device_degraded"][-1]
        assert deg.fields["where"] == "build" and deg.fields["to_rung"] == 0
    finally:
        m.close()


def case_card_ladder_ends_at_rung_one():
    base = _counter("device.degraded_total")
    lad = DeviceBackendLadder(0, degrade_after=1, heal_policy=FAST, cpu_rung=False)
    assert lad.current() == 1 == lad.bottom() and lad.at_bottom()
    for where in ("drain", "drain", "build", "scrub"):
        assert not lad.note_failure(ENVIRONMENT, where, immediate=where == "build")
    assert not lad.note_failure("corruption", "scrub")
    assert lad.current() == 1 and not lad.degraded() and not lad.heal_due()
    assert _counter("device.degraded_total") == base
    assert DeviceBackendLadder(0).bottom() == 0 and DeviceBackendLadder(4, cpu_rung=False).bottom() == 1


def case_cpu_rung_bit_identical_to_golden_tree():
    from merklekv_tpu_torch.merkle.cpu import build_levels
    from merklekv_tpu_torch.merkle.encoding import leaf_hash

    items = {b"cpu:%04d" % i: b"v%d" % i for i in range(111)}
    st = build_state_for_rung(0, items.items())

    def golden():
        return build_levels([leaf_hash(k, v) for k, v in sorted(items.items())])

    assert st.root_hex() == golden()[-1][0].hex()
    st.apply([(b"cpu:0000", b"changed")])
    assert st.pending_count() == 1
    assert st.root_hex(flush=False) == golden()[-1][0].hex()
    items[b"cpu:0000"] = b"changed"
    st.flush_pending()
    assert st.root_hex(flush=False) == golden()[-1][0].hex()
    st.apply([(b"zzz:new", b"n"), (b"cpu:0001", None)])
    items[b"zzz:new"] = b"n"
    del items[b"cpu:0001"]
    st.flush_pending()
    glv = golden()
    for lvl in range(len(glv)):
        rows, n = st.level_nodes(lvl, 0, len(glv[lvl]))
        assert n == len(items) and [d for _, d in rows] == glv[lvl]
    assert st._n_shards == 0


PORT_CASES = {name[len("case_"):]: fn for name, fn in globals().items()
              if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_port_guard_and_ladder(case):
    try:
        PORT_CASES[case]()
    finally:
        guard_mod.set_inject(None)
