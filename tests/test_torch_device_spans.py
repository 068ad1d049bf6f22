"""Device spans of the anti-entropy cycle (``utils.tracing.device_span``).

Off (no profiler session recording on the calling thread) a span is one
shared no-op: no ``record_function``, no CUDA event, no record, and the
cycle's answers are the same bit for bit. On, under a session on the
calling thread, each cycle leaves its ``ae.*`` spans in the ring and in the
session's trace. On the CPU no device time is ever filled in; the event
arithmetic runs here on stand-in events and on the card in
``tests/test_torch_cuda.py``.
"""

import collections
import json
import logging
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merklekv_tpu_torch.merkle import diff as mdiff
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.parallel import sharded_merkle
from merklekv_tpu_torch.parallel.mesh import make_mesh
from merklekv_tpu_torch.utils import tracing

CPU = torch.device("cpu")
# The leaf hash, the diff (on a card beside the leaf hash and the levels),
# the levels, then the wait for the diff.
PHASES = ["ae.leaf", "ae.diff", "ae.levels", "ae.diff_wait"]
# A key-mesh step of 4 shards: every shard's leaf hash, every shard's diff,
# the masks' gather, every shard's seam and wait for its diff, then the
# combine with the seam and the wait for the masks inside it.
MESH_SPANS = ["ae.cycle", *["ae.leaf"] * 4, *["ae.diff"] * 4, "ae.gather",
              *["ae.levels", "ae.diff_wait"] * 4,
              "ae.combine", "ae.seam", "ae.gather_wait"]


def _inputs(n=16, b=2, r=3, seed=7):
    rng = np.random.RandomState(seed)
    blocks = torch.from_numpy(rng.randint(0, 2**32, (n, b, 16), dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
    nblocks = torch.from_numpy(rng.randint(1, b + 1, n).astype(np.int32))
    base = rng.randint(0, 2**32, (1, n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)
    digests = torch.from_numpy(np.repeat(base, r, axis=0))
    digests[1, 3, 2] ^= 1
    present = torch.ones((r, n), dtype=torch.bool)
    present[2, 5] = False
    return blocks, nblocks, digests, present


@pytest.fixture(autouse=True)
def empty_ring():
    tracing.clear_device_spans()
    yield
    tracing.clear_device_spans()


def _raise(*_a, **_k):
    raise AssertionError("touched with no profiler session on the thread")


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    assert tracing.device_span("ae.cycle", CPU) is tracing.device_span("ae.leaf", "cuda:0")
    te.anti_entropy_forward(*_inputs(), device=CPU)
    mesh = make_mesh({"key": 4}, devices=[CPU] * 4)
    sharded_merkle.make_anti_entropy_step(mesh)(*_inputs())
    assert tracing.device_spans() == [] and tracing.device_spans_dropped() == 0


def test_answers_are_the_same_with_spans_on_and_off():
    args = _inputs()
    off = te.anti_entropy_forward(*args, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        on = te.anti_entropy_forward(*args, device=CPU)
    assert [s["name"] for s in tracing.device_spans()] == ["ae.cycle", *PHASES]
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_on_records_the_cycle_and_its_phases(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        te.anti_entropy_forward(*_inputs(), device=CPU)
    recs = tracing.device_spans()
    assert [s["name"] for s in recs] == ["ae.cycle", *PHASES]
    top = recs[0]
    assert top["parent"] is None and top["root"] == top["id"]
    for s in recs[1:]:
        assert s["parent"] == top["id"] and s["root"] == top["id"]
    assert len({s["id"] for s in recs}) == 1 + len(PHASES)
    times = [top["host_ns"][0]]
    for s in recs[1:]:
        times += list(s["host_ns"])
    times.append(top["host_ns"][1])
    assert times == sorted(times) and None not in times
    for s in recs:
        assert s["device_ms"] is None and s["between_ms"] is None
        assert s["device"] is None and s["cycle"] is None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"ae.cycle", *PHASES} <= names


def test_the_sync_cycle_id_is_stamped():
    from merklekv_tpu_torch.obs.trace import cycle_scope

    with profile(activities=[ProfilerActivity.CPU]), cycle_scope(4242):
        te.anti_entropy_forward(*_inputs(), device=CPU)
    assert {s["cycle"] for s in tracing.device_spans()} == {4242}


def test_sharded_step_records_each_shard_and_one_combine():
    mesh = make_mesh({"key": 4}, devices=[CPU] * 4)
    step = sharded_merkle.make_anti_entropy_step(mesh)
    args = _inputs()
    off = step(*args)
    with profile(activities=[ProfilerActivity.CPU]):
        on = step(*args)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    for a, b in zip(on, te.anti_entropy_forward(*args, device=CPU)):
        assert torch.equal(a, b)
    recs = tracing.device_spans()
    assert [s["name"] for s in recs] == MESH_SPANS
    top = recs[0]
    assert all(s["root"] == top["id"] for s in recs[1:])
    assert all(s["parent"] == top["id"] for s in recs[1:-2])
    assert recs[-1]["parent"] == recs[-2]["parent"] == recs[-3]["id"]


def _counters():
    c = tracing.get_metrics().snapshot()["counters"]
    return c.get("device.ae_mesh_steps", 0), c.get("device.ae_combine_bytes", 0)


def test_the_seam_span_and_the_combine_counters():
    """24 keys over 4 shards (6 a shard): each shard's seam is its 3 nodes of
    level 1. Under a session ``ae.seam`` lies inside ``ae.combine`` on the
    first device; with none nothing is recorded. Either way a step counts
    once, and the bytes of shards 1-3's seams, masks and counts."""
    mesh = make_mesh({"key": 4}, devices=[CPU] * 4)
    step = sharded_merkle.make_anti_entropy_step(mesh)
    args = _inputs(n=24)
    r = args[2].shape[0]
    per_step = 3 * (3 * 8 * 4 + r * 6 + r * 4)
    steps0, bytes0 = _counters()
    off = step(*args)
    assert tracing.device_spans() == []
    assert _counters() == (steps0 + 1, bytes0 + per_step)
    with profile(activities=[ProfilerActivity.CPU]):
        on = step(*args)
    assert _counters() == (steps0 + 2, bytes0 + 2 * per_step)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    recs = {s["name"]: s for s in tracing.device_spans()}
    seam, combine, cycle = recs["ae.seam"], recs["ae.combine"], recs["ae.cycle"]
    assert seam["parent"] == combine["id"] and combine["parent"] == cycle["id"]
    assert seam["device"] == combine["device"] == cycle["device"]
    assert combine["host_ns"][0] <= seam["host_ns"][0] <= seam["host_ns"][1] <= combine["host_ns"][1]


def test_the_gather_spans_and_the_combine_bytes():
    """The masks' gather is ``ae.gather`` after the last shard's diff and
    before the first seam, on the first device; the wait for it is
    ``ae.gather_wait`` inside ``ae.combine``, after ``ae.seam``. A step
    still counts the bytes of shards 1-3's seams, masks and counts, and
    the masks it returns are one contiguous [R, N] tensor equal to the
    shards' own masks side by side."""
    mesh = make_mesh({"key": 4}, devices=[CPU] * 4)
    step = sharded_merkle.make_anti_entropy_step(mesh)
    args = _inputs(n=24)
    r = args[2].shape[0]
    steps0, bytes0 = _counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _root, masks, _counts = step(*args)
    assert _counters() == (steps0 + 1, bytes0 + 3 * (3 * 8 * 4 + r * 6 + r * 4))
    want = torch.cat([dispatch.divergence(args[2][:, s * 6:(s + 1) * 6],
                                          args[3][:, s * 6:(s + 1) * 6])[0] for s in range(4)],
                     dim=1)
    assert masks.is_contiguous() and masks.shape == (r, 24) and torch.equal(masks, want)
    recs = tracing.device_spans()
    by = {s["name"]: s for s in recs}
    cycle, gather, wait, combine = (by[n] for n in ("ae.cycle", "ae.gather", "ae.gather_wait",
                                                    "ae.combine"))
    assert gather["parent"] == cycle["id"] and gather["device"] == cycle["device"]
    last_diff = [s for s in recs if s["name"] == "ae.diff"][-1]["host_ns"][1]
    first_seam = next(s for s in recs if s["name"] == "ae.levels")["host_ns"][0]
    assert last_diff <= gather["host_ns"][0] <= gather["host_ns"][1] <= first_seam
    assert wait["parent"] == combine["id"] and wait["device"] == combine["device"]
    assert by["ae.seam"]["host_ns"][1] <= wait["host_ns"][0] <= wait["host_ns"][1]
    assert wait["host_ns"][1] <= combine["host_ns"][1]


@pytest.mark.parametrize("where", ["one_device", "mesh"])
def test_the_diff_wait_lies_in_the_cycle_after_the_levels(where):
    """Under a session each diff's wait is one ``ae.diff_wait`` in
    ``ae.cycle`` on the diff's device, after that device's ``ae.levels``
    (on a mesh each shard's, before ``ae.combine``): one wait a diff."""
    args = _inputs(n=24)
    with profile(activities=[ProfilerActivity.CPU]):
        if where == "mesh":
            step = sharded_merkle.make_anti_entropy_step(make_mesh({"key": 4}, devices=[CPU] * 4))
            step(*args)
        else:
            te.anti_entropy_forward(*args, device=CPU)
    recs = tracing.device_spans()
    cycle = recs[0]
    diffs = [s for s in recs if s["name"] == "ae.diff"]
    waits = [s for s in recs if s["name"] == "ae.diff_wait"]
    levels = [s for s in recs if s["name"] == "ae.levels"]
    assert cycle["name"] == "ae.cycle" and len(waits) == len(diffs) == len(levels) >= 1
    for wait, level in zip(waits, levels):
        assert wait["parent"] == cycle["id"] and wait["device"] == level["device"]
        assert level["host_ns"][1] <= wait["host_ns"][0] <= wait["host_ns"][1]
        assert wait["host_ns"][1] <= cycle["host_ns"][1]
    combine = [s for s in recs if s["name"] == "ae.combine"]
    if combine:
        assert waits[-1]["host_ns"][1] <= combine[0]["host_ns"][0]


def test_no_diff_runs_beside_on_the_cpu():
    """``device.ae_diff_overlapped`` counts diffs that ran on a card's side
    stream: on the CPU the step runs in turn and counts none."""
    def overlapped():
        return tracing.get_metrics().snapshot()["counters"].get("device.ae_diff_overlapped", 0)

    before = overlapped()
    args = _inputs()
    te.anti_entropy_forward(*args, device=CPU)
    sharded_merkle.make_anti_entropy_step(make_mesh({"key": 4}, devices=[CPU] * 4))(*args)
    with profile(activities=[ProfilerActivity.CPU]):
        te.anti_entropy_forward(*args, device=CPU)
    assert overlapped() == before


def _ragged_inputs(seed=7):
    """A ragged set of 40 leaves of 1 to 5 blocks with the digests and
    presence of ``_inputs``."""
    from merklekv_tpu_torch.merkle.ragged import RaggedLeaves

    rng = np.random.RandomState(seed)
    keys = [b"rk%03d" % i for i in range(40)]
    values = [bytes(rng.randint(0, 256, rng.randint(0, 300), dtype=np.uint8)) for _ in keys]
    _b, _nb, digests, present = _inputs(n=40, seed=seed)
    return RaggedLeaves.pack(keys, values, CPU), digests, present


def _lane_counters():
    counters = tracing.get_metrics().snapshot()["counters"]
    return counters.get("device.ae_leaf_blocks", 0), counters.get("device.ae_leaf_lane_slots", 0)


def test_a_ragged_cycle_records_the_same_spans_and_counts_its_lanes():
    """A ragged set hashes inside ``ae.leaf``: the cycle's spans are the
    padded cycle's. Each step adds the set's blocks and lane slots to the
    two counters once, spans on or off."""
    leaves, digests, present = _ragged_inputs()
    before = _lane_counters()
    off = te.anti_entropy_forward(leaves, None, digests, present, device=CPU)
    assert tracing.device_spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = te.anti_entropy_forward(leaves, None, digests, present, device=CPU)
    assert [s["name"] for s in tracing.device_spans()] == ["ae.cycle", *PHASES]
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    after = _lane_counters()
    assert after[0] - before[0] == 2 * leaves.total_blocks
    assert after[1] - before[1] == 2 * leaves.lane_slots
    assert leaves.total_blocks <= leaves.lane_slots


def test_the_node_paths_count_their_ragged_hashes():
    """``leaf_digests`` (the node's sync leaf map, the snapshot root, the
    tree engine) packs ragged and counts its hash like the step does; a
    benchmark's own call of ``dispatch.hash_ragged`` counts nothing."""
    leaves, _d, _p = _ragged_inputs(seed=8)
    before = _lane_counters()
    dispatch.hash_ragged(leaves)
    assert _lane_counters() == before
    keys, values = [b"a", b"b" * 200], [b"", b"v" * 5000]  # 1 and 82 blocks
    te.leaf_digests(keys, values, device=CPU)
    after = _lane_counters()
    assert after[0] - before[0] == 1 + 82 and after[1] - before[1] == 32 * 82


def test_no_span_outside_the_cycle():
    """The layers the cycle calls record nothing of their own: a caller of
    them outside the cycle (the serving mirror, a benchmark's probe) leaves
    the ring empty."""
    blocks, nblocks, digests, present = _inputs()
    with profile(activities=[ProfilerActivity.CPU]):
        leaves = dispatch.hash_blocks(blocks, nblocks)
        dispatch.build_levels(leaves)
        mdiff.divergence_masks(digests, present).sum(dim=1, dtype=torch.int32)
    assert tracing.device_spans() == []


def test_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_RING", collections.deque(maxlen=8))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(11):
            with tracing.device_span(f"s{i}", CPU):
                pass
    recs = tracing.device_spans()
    assert [s["name"] for s in recs] == [f"s{i}" for i in range(3, 11)]
    assert tracing.device_spans_dropped() == 3
    tracing.clear_device_spans()
    assert tracing.device_spans() == [] and tracing.device_spans_dropped() == 0


def test_a_session_on_another_thread_turns_nothing_on():
    running, done = threading.Event(), threading.Event()
    seen = []

    def other():
        with profile(activities=[ProfilerActivity.CPU]):
            seen.append(torch._C._autograd._profiler_enabled())
            running.set()
            done.wait(30)

    t = threading.Thread(target=other)
    t.start()
    try:
        assert running.wait(30)
        te.anti_entropy_forward(*_inputs(), device=CPU)
    finally:
        done.set()
        t.join(30)
    assert not t.is_alive() and seen == [True]
    assert tracing.device_spans() == []


class _Ev:
    """A stand-in CUDA event: a device time in ms, complete or not."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t - self.t


def _span(name, parent, device, start, end, session=1):
    s = tracing._DeviceSpan(name, device)
    s.id = next(tracing._span_ids)
    s.parent = parent.id if parent is not None else None
    s.root = parent.root if parent is not None else s.id
    s.session = session
    s.index, s.cycle, s.t0_ns, s.t1_ns = device, None, 1, 2
    s.start, s.end = start, end
    tracing._RING.append(s)
    return s


def test_device_times_and_the_gap_between_root_spans():
    a = _span("ae.cycle", None, 0, _Ev(0.0), _Ev(10.0))
    _span("ae.leaf", a, 0, _Ev(1.0), _Ev(6.0))
    _span("ae.cycle", None, 1, _Ev(3.0), _Ev(9.0))  # another card: its own chain
    b = _span("ae.cycle", None, 0, _Ev(10.5), _Ev(20.0))
    _span("ae.leaf", b, 0, _Ev(11.0), _Ev(15.0, done=False))
    _span("ae.cycle", None, 0, _Ev(21.25, done=False), _Ev(30.0))
    recs = tracing.device_spans()
    assert [s["device_ms"] for s in recs] == [10.0, 5.0, 6.0, 9.5, None, None]
    assert [s["between_ms"] for s in recs] == [None, None, None, 0.5, None, None]


def test_the_gap_between_root_spans_does_not_cross_sessions():
    _span("ae.cycle", None, 0, _Ev(0.0), _Ev(10.0), session=1)
    _span("ae.cycle", None, 0, _Ev(10.5), _Ev(20.0), session=1)
    _span("ae.cycle", None, 0, _Ev(900.0), _Ev(910.0), session=2)
    _span("ae.cycle", None, 0, _Ev(910.25), _Ev(920.0), session=2)
    assert [s["between_ms"] for s in tracing.device_spans()] == [None, 0.5, None, 0.25]


def test_each_recording_is_a_session_of_its_own(tmp_path):
    """A thread's spans start a new session after a cycle ran untraced
    between two recordings (a tracer that records a second time later in a
    window), and at each ``device_profile``, even with nothing between."""
    args = _inputs()
    with profile(activities=[ProfilerActivity.CPU]):
        te.anti_entropy_forward(*args, device=CPU)
        te.anti_entropy_forward(*args, device=CPU)
    te.anti_entropy_forward(*args, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        te.anti_entropy_forward(*args, device=CPU)
    for name in ("a", "b"):
        with tracing.device_profile(str(tmp_path / name)):
            te.anti_entropy_forward(*args, device=CPU)
    roots = [s for s in tracing.device_spans() if s["parent"] is None]
    sessions = [s["session"] for s in roots]
    assert len(roots) == 5 and sessions[0] == sessions[1]
    assert len(set(sessions[1:])) == 4 and sessions == sorted(sessions)
    for s in tracing.device_spans():
        assert s["session"] == next(r["session"] for r in roots if r["id"] == s["root"])


def test_span_with_info_off_still_counts_and_serialises_nothing(monkeypatch):
    log = logging.getLogger("merklekv")
    level = log.level
    monkeypatch.setattr(tracing.json, "dumps", _raise)
    before = tracing.get_metrics().snapshot()["spans"].get("device_spans.quiet", {})
    log.setLevel(logging.WARNING)
    try:
        with tracing.span("device_spans.quiet", peer="x") as extra:
            extra["n"] = 1
    finally:
        log.setLevel(level)
    after = tracing.get_metrics().snapshot()["spans"]["device_spans.quiet"]
    assert after["count"] == before.get("count", 0) + 1


def test_span_with_info_on_logs_its_record(caplog):
    with caplog.at_level(logging.INFO, logger="merklekv"):
        with tracing.span("device_spans.loud", peer="x"):
            pass
    recs = [json.loads(r.getMessage()) for r in caplog.records if "device_spans.loud" in r.getMessage()]
    assert len(recs) == 1 and recs[0]["peer"] == "x" and recs[0]["seconds"] >= 0
