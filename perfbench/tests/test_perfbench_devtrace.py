"""The trace arithmetic on a made-up timeline."""

from perfbench import readers
from perfbench.devtrace import DeviceTrace
from perfbench.harness import Readings

# (name, start us, duration us) on the trace clock; the host's clock is the
# trace's less 1000 us
OPS = [("marker", 1000.0, 1.0), ("k1", 1010.0, 40.0), ("k2", 1030.0, 30.0), ("adam", 1100.0, 10.0)]
SPANS = [("train_step", 5_000, 95_000), ("forward", 5_000, 40_000), ("adam", 80_000, 95_000)]


def make():
    return DeviceTrace(OPS, 1000.0, 1130.0, SPANS, 1000.0, 2)


def test_busy_is_the_union():
    tr = make()
    assert tr.busy_us == 1.0 + 50.0 + 10.0  # k1 and k2 overlap over 1030-1050
    assert tr.span_us == 130.0
    assert tr.total_us() == 81.0


def test_roles():
    tr = make()
    assert tr.role_us(["k1", "k2"]) == 70.0
    assert tr.role_us([]) == 0.0
    assert tr.time_by_name()["adam"] == 10.0


def test_idle_gaps_by_host_span():
    idle = make().idle_by_host()
    # gaps: 1001-1010 (mid 1005.5 -> host 5.5 us: forward, inside
    # train_step), 1060-1100 (mid 1080 -> host 80 us: adam), 1110-1130 (mid
    # 1120 -> host 120 us: no span)
    assert idle == {"forward": 9.0, "adam": 40.0, "other": 20.0}
    assert sum(idle.values()) == make().span_us - make().busy_us


def test_idle_is_read_against_the_untraced_window():
    # 61 us busy over the slice's 2 units; the window ran 10 units in 1 ms
    r = Readings(units=10, window_s=1e-3, spans_s={}, launches={}, peak_window_bytes=0,
                 work={}, dtype="float32", trace=make(), roles={})
    assert abs(readers.device_idle(r) - 100.0 * (1.0 - 30.5 / 100.0)) < 1e-9
    assert readers.device_idle(Readings(**dict(r.__dict__, trace=None))) is None
