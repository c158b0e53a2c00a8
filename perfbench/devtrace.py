"""What a profiler trace of the CUDA activity says: the device's busy time
(the union of its operations' intervals), time by operation and by layer
role, and the idle gaps labelled by what the host was doing.

The trace records the CUDA activity only: tracing the CPU ops inflates a
host-held step's span (`lushnerf_torch/scripts/trace_span.py`).  The
arithmetic of `chip_smoke.device_trace`: the optimizer's user annotations
also land on the device timeline and are left out, so nothing counts
twice.  Host spans (perf_counter_ns) are put on the trace's clock by a
marker launched right after a synchronize: the first device operation of
the trace.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

Span = Tuple[str, int, int]  # (name, start ns, end ns) on the host's perf_counter_ns


class DeviceTrace:
    def __init__(self, ops: List[Tuple[str, float, float]], start_us: float, end_us: float,
                 host_spans: List[Span], offset_us: float, units: int):
        self.ops = ops  # (name, start us, duration us), device operations in start order
        self.start_us, self.end_us = start_us, end_us  # the traced window, on the trace's clock
        self.host_spans = host_spans
        self.offset_us = offset_us  # trace clock = host perf_counter us + offset
        self.units = units  # iterations or views inside the traced window

    @property
    def span_us(self) -> float:
        return self.end_us - self.start_us

    @property
    def busy_us(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, s, d in self.ops:
            t = s + d
            if t > end:
                busy += t - max(s, end)
                end = t
        return busy

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, d in self.ops:
            out[name] = out.get(name, 0.0) + d
        return out

    def role_us(self, patterns: List[str]) -> float:
        """Device time of the operations whose name holds one of `patterns`."""
        return sum(d for name, _, d in self.ops if any(p in name for p in patterns))

    def total_us(self) -> float:
        return sum(d for _, _, d in self.ops)

    def idle_by_host(self) -> Dict[str, float]:
        """Idle device time (us) by the host span in which each gap's middle
        falls (the innermost, i.e. the latest-starting one), 'other' where
        none does."""
        gaps, end = [], self.start_us
        for _, s, d in self.ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        if self.end_us > end:
            gaps.append((end, self.end_us))
        spans = sorted(((n, a / 1e3 + self.offset_us, b / 1e3 + self.offset_us)
                        for n, a, b in self.host_spans), key=lambda x: x[1])
        out: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = "other"
            for n, s, e in spans:
                if s > mid:
                    break
                if e >= mid:
                    label = n
            out[label] = out.get(label, 0.0) + (b - a)
        return out


def trace(fn: Callable[[], int], host_spans: List[Span]) -> Optional[DeviceTrace]:
    """Runs fn (which returns the units it did) under torch.profiler with the
    CUDA activity only.  None where the profiler recorded no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter_ns()
        marker.add_(1.0)
        units = fn()
        torch.cuda.synchronize()
        t_end = time.perf_counter_ns()
    ops = sorted(((e.name, float(e.time_range.start), float(e.time_range.elapsed_us()))
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("Optimizer.")), key=lambda o: o[1])
    if not ops:
        return None
    offset = ops[0][1] - t_mark / 1e3
    return DeviceTrace(ops, ops[0][1], t_end / 1e3 + offset, host_spans, offset, units)
