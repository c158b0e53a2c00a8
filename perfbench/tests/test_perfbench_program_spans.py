"""The readers of the program's spans on a made-up timeline: gaps put under
the phase whose span holds their middle, through the slice's offset;
counts and durations over the slice's units; None where the slice holds no
program span."""

import collections

import pytest

from perfbench import program_spans
from perfbench.devtrace import DeviceTrace
from perfbench.harness import load_module, PKG

from lushnerf_torch.utils import trace

# the trace's clock is the host's perf_counter (us) plus OFFSET
OFFSET = 5000.0
# (name, start us, duration us) on the trace clock: the marker at 6000, then
# gaps 6001-6010 (host 1001-1010), 6050-6100 (1050-1100), 6150-6300
# (1150-1300), 6310-6400 (1310-1400)
OPS = [("marker", 6000.0, 1.0), ("k1", 6010.0, 40.0), ("k2", 6020.0, 10.0),
       ("k3", 6100.0, 50.0), ("k4", 6300.0, 10.0)]
UNITS = 2


def rec(name, a_us, b_us, thread=1):
    """A record at host times a_us..b_us (perf_counter us)."""
    return trace.Record(name, int(a_us * 1e3), int(b_us * 1e3), thread, None, None,
                        int((b_us - a_us) * 1e3))


RECORDS = [
    rec("train.forward", 1000, 1020),  # holds the middle of gap 1001-1010
    rec("sync.pack_range", 1002, 1008),
    rec("mlp.pack", 1001, 1009),
    rec("train.backward", 1040, 1310),  # gaps 1050-1100 and 1150-1300
    rec("mlp.pack", 1060, 1090, thread=2),  # another thread, inside the backward
    rec("sync.pack_range", 1062, 1070, thread=2),
    rec("sync.cumprod_backward", 1200, 1280, thread=2),
    rec("train.optimizer", 1310, 1400),  # gap 1310-1400
    rec("train.forward", 500, 600),  # before the slice: left out
    rec("sync.pack_range", 1395, 1500),  # ends after the slice: left out
]


def make(ops=OPS):
    return DeviceTrace(ops, 6000.0, 6400.0, [], OFFSET, UNITS)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(RECORDS))


def test_gaps_go_under_the_span_that_holds_their_middle(recorded):
    tr = make()
    assert program_spans.gaps(tr) == [(6001.0, 6010.0), (6050.0, 6100.0), (6150.0, 6300.0),
                                      (6310.0, 6400.0)]
    assert program_spans.idle_ms(tr, "train.forward") == pytest.approx(9.0 / 1e3 / UNITS)
    assert program_spans.idle_ms(tr, "train.backward") == pytest.approx(200.0 / 1e3 / UNITS)
    # the gap 6310-6400: its middle (host 1355) lies in the optimizer
    assert program_spans.idle_ms(tr, "train.optimizer") == pytest.approx(90.0 / 1e3 / UNITS)
    # by time, whatever the thread: the backward's syncs on thread 2
    assert program_spans.idle_ms(tr, "sync.") == pytest.approx(
        (9.0 + 150.0) / 1e3 / UNITS)


def test_without_the_offset_the_gaps_fall_elsewhere(recorded):
    tr = DeviceTrace(OPS, 6000.0, 6400.0, [], 0.0, UNITS)
    # the host window is then 6000-6400 us: no record lies inside it
    assert program_spans.idle_ms(tr, "train.forward") is None


def test_counts_and_durations_are_over_the_units(recorded):
    tr = make()
    assert program_spans.count(tr, "mlp.pack") == 2 / UNITS
    assert program_spans.count(tr, "sync.") == 3 / UNITS
    assert program_spans.count(tr, "train.eval") == 0.0
    assert program_spans.host_ms(tr, "train.forward") == pytest.approx(20.0 / 1e3 / UNITS)
    assert program_spans.host_ms(tr, "sync.") == pytest.approx((6 + 8 + 80) / 1e3 / UNITS)


def test_none_where_the_slice_holds_no_program_span(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(RECORDS[-2:]))
    tr = make()
    for fn in (program_spans.host_ms, program_spans.count, program_spans.idle_ms):
        assert fn(tr, "train.forward") is None
    assert program_spans.host_ms(None, "train.forward") is None
    assert program_spans.count(DeviceTrace(OPS, 6000.0, 6400.0, [], OFFSET, 0), "sync.") is None


@pytest.mark.parametrize("name,value", [
    ("forward_host_ms.train", 20.0 / 1e3 / UNITS),
    ("backward_host_ms.train", 270.0 / 1e3 / UNITS),
    ("optimizer_host_ms.train", 90.0 / 1e3 / UNITS),
    ("forward_idle_ms.train", 9.0 / 1e3 / UNITS),
    ("backward_idle_ms.train", 200.0 / 1e3 / UNITS),
    ("host_syncs.train", 3 / UNITS),
    ("sync_wait_ms.train", 94.0 / 1e3 / UNITS),
    ("mlp_packs.train", 2 / UNITS),
])
def test_each_reader(recorded, name, value):
    from perfbench.harness import Readings

    reader = load_module(PKG / "metrics" / f"{name}.py", "perfbench_metric_test")
    r = Readings(units=10, window_s=1.0, spans_s={}, launches={}, peak_window_bytes=0,
                 work={}, dtype="float32", trace=make(), roles={})
    assert reader.read(r) == pytest.approx(value)
    assert reader.read(Readings(**dict(r.__dict__, trace=None))) is None


def keyed(name, key, a_us, b_us):
    return trace.Record(name, int(a_us * 1e3), int(b_us * 1e3), 1, None, key,
                        int((b_us - a_us) * 1e3))


# three iterations of a window: each a train.iteration span keyed by its
# iteration, a train.step inside it (the key inherited), and other spans
WINDOW = [
    keyed("train.next_batch", 1, 0, 1), keyed("train.step", 1, 2, 10),
    keyed("train.iteration", 1, 0, 11),
    keyed("train.next_batch", 2, 11, 12), keyed("train.step", 2, 13, 23),
    keyed("train.iteration", 2, 11, 25),
    keyed("train.step", 3, 26, 38), keyed("train.iteration", 3, 25, 40),
    keyed("mlp.bwd", None, 30, 31),
]
NAMES = ("train.iteration", "train.step")


def test_by_unit_sums_each_name_over_the_units():
    got = program_spans.by_unit(WINDOW, NAMES, 3)
    assert got == pytest.approx({"train.iteration": 40e-6, "train.step": 30e-6})


def test_by_unit_scales_what_the_ring_kept_to_every_unit():
    # the ring lost the window's first records: iteration 1 whole, and
    # iteration 2's step, whose iteration span (ending later) it kept
    kept = WINDOW[4:]
    got = program_spans.by_unit(kept[1:], NAMES, 3)
    assert got == pytest.approx({"train.iteration": 3 * 15e-6, "train.step": 3 * 12e-6})
    assert program_spans.by_unit([], NAMES, 3) == {}
    assert program_spans.by_unit(WINDOW[:2], NAMES, 3) == {}


@pytest.mark.parametrize("name,value", [
    ("loop_host_ms.train", (40 - 30) * 1e-3 / 3),
    ("step_host_ms.train", 30 * 1e-3 / 3),
])
def test_the_window_readers(name, value):
    from perfbench.harness import Readings

    reader = load_module(PKG / "metrics" / f"{name}.py", "perfbench_metric_test")
    spans_s = dict(program_spans.by_unit(WINDOW, NAMES, 3), train_step=1.0, loop=1.0)
    r = Readings(units=3, window_s=1.0, spans_s=spans_s, launches={}, peak_window_bytes=0,
                 work={}, dtype="float32", trace=None, roles={})
    assert reader.read(r) == pytest.approx(value)
    # the benchmark's own spans alone are not the program's
    assert reader.read(Readings(**dict(r.__dict__, spans_s={"train_step": 1.0,
                                                           "loop": 1.0}))) is None
