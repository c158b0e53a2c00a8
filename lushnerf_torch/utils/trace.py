"""Spans of the port's phases, on the host's perf_counter_ns clock.

    from lushnerf_torch.utils import trace

    with trace.span("train.step"):
        ...
    trace.spans(since_ns, until_ns)  # the records inside the interval

A span records only while a torch profiler is capturing, or inside
`trace.recording()` (tests, and measuring what the spans cost).  Off,
`span` returns one shared no-op object: no allocation, no sync, no device
call.  On, each span also opens a `torch.profiler.record_function` range of
its name while a profiler captures, so the profiler's trace shows the
program's phases.

A record holds the name, start and end (perf_counter_ns: the clock a
profiler trace's marker ties to the device's), the thread, the name of the
enclosing span on that thread, the key (a span without one inherits its
parent's: the iteration under `train.iteration`, the view under
`render.view`) and the self time (the duration less that of its direct
children on its thread).  Records go to a bounded in-memory ring; there is
no counter API: a count is the number of a name's spans in an interval.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Iterator, List, NamedTuple, Optional

import torch

RING = 1 << 16  # records kept, the newest


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    key: Any
    self_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


_ring: collections.deque = collections.deque(maxlen=RING)
_local = threading.local()
_lock = threading.Lock()
_recording = 0  # open `recording()` contexts, over all threads
_profiling = torch._C._autograd._profiler_enabled


class _Off:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "key", "parent", "start", "child_ns", "range")

    def __init__(self, name: str, key: Any):
        self.name, self.key = name, key

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.key is None and top is not None:
            self.key = top.key
        self.child_ns = 0
        self.range = None
        if _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _local.stack
        stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        ns = end - self.start
        if stack:
            stack[-1].child_ns += ns
        _ring.append(Record(self.name, self.start, end, threading.get_ident(), self.parent,
                            self.key, ns - self.child_ns))
        return False


def span(name: str, key: Any = None):
    """A context manager that records one span of `name` while a profiler
    captures or `recording()` is open; else the shared no-op `OFF`."""
    if _recording or _profiling():
        return _Span(name, key)
    return OFF


def span_backward(t: torch.Tensor, name: str) -> None:
    """Records a span of `name` around the autograd node that made t
    (t.grad_fn) when a backward runs it, if spans record now: for work that
    runs inside torch's backward, where no `with` reaches."""
    node = t.grad_fn
    if node is None or not (_recording or _profiling()):
        return
    opened: List[_Span] = []

    def pre(grad_outputs):
        opened.append(_Span(name, None).__enter__())

    def post(grad_inputs, grad_outputs):
        opened.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans record inside this context, on every thread, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(since_ns: Optional[int] = None, until_ns: Optional[int] = None) -> List[Record]:
    """The records in the ring that started at or after since_ns and ended
    at or before until_ns (either None: unbounded), in the order they
    ended."""
    return [r for r in list(_ring)
            if (since_ns is None or r.start_ns >= since_ns)
            and (until_ns is None or r.end_ns <= until_ns)]
