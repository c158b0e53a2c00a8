"""Shared arithmetic of the per-layer metrics that read the program's own
spans (`lushnerf_torch.utils.trace`): those recorded inside the traced
slice's host window, put on the device trace's clock through the slice's
marker (`DeviceTrace.offset_us`), a unit at a time; and (`by_unit`) those
a driver records over its untraced window under `trace.recording()`.

A name ending in "." selects every span under it ("sync." is each host
sync).  Each function returns None where the slice holds no program span
(a program that records none, or no slice), and the harness then leaves the
metric out of the result line.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple


def slice_records(tr) -> Optional[list]:
    """The program's span records inside the slice's host window
    [tr.start_us - tr.offset_us, tr.end_us - tr.offset_us]; None where
    there are none."""
    if tr is None or not tr.units:
        return None
    try:
        from lushnerf_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    since = math.floor(1e3 * (tr.start_us - tr.offset_us))
    until = math.ceil(1e3 * (tr.end_us - tr.offset_us))
    return trace.spans(since, until) or None


def by_unit(records, names, units: int) -> Dict[str, float]:
    """Host seconds over a window's `units` in the spans of each of `names`,
    from the program's records of that window.  A span carries its unit's
    key (the iteration under `train.iteration`); only the units that hold a
    span of every name count, and their sums are scaled to all `units`: the
    program's ring keeps the newest records, so a window longer than it
    holds loses its first units whole or in part.  Empty where no unit
    holds them all."""
    ns: Dict[str, Dict[object, int]] = {n: {} for n in names}
    for r in records:
        if r.name in ns and r.key is not None:
            ns[r.name][r.key] = ns[r.name].get(r.key, 0) + r.end_ns - r.start_ns
    keys = set.intersection(*(set(d) for d in ns.values()))
    if not keys:
        return {}
    scale = units / len(keys)
    return {n: scale * sum(d[k] for k in keys) / 1e9 for n, d in ns.items()}


def _named(recs, name: str) -> list:
    if name.endswith("."):
        return [r for r in recs if r.name.startswith(name)]
    return [r for r in recs if r.name == name]


def host_ms(tr, name: str) -> Optional[float]:
    """Host ms a unit in the spans of `name`."""
    recs = slice_records(tr)
    if recs is None:
        return None
    return sum(r.end_ns - r.start_ns for r in _named(recs, name)) / 1e6 / tr.units


def count(tr, name: str) -> Optional[float]:
    """Spans of `name` a unit."""
    recs = slice_records(tr)
    if recs is None:
        return None
    return len(_named(recs, name)) / tr.units


def gaps(tr) -> List[Tuple[float, float]]:
    """The slice's idle intervals (us, trace clock): between the union of
    its device operations, from its start to its end."""
    out, end = [], tr.start_us
    for _, s, d in tr.ops:
        if s > end:
            out.append((end, s))
        end = max(end, s + d)
    if tr.end_us > end:
        out.append((end, tr.end_us))
    return out


def idle_ms(tr, name: str) -> Optional[float]:
    """Device-idle ms a unit in the gaps whose middle falls inside a span of
    `name`, on whatever thread: put down by time, not by parentage."""
    recs = slice_records(tr)
    if recs is None:
        return None
    spans = sorted((r.start_ns / 1e3 + tr.offset_us, r.end_ns / 1e3 + tr.offset_us)
                   for r in _named(recs, name))
    starts = [a for a, _ in spans]
    ends, reach = [], float("-inf")  # the latest end among spans starting no later
    for _, b in spans:
        reach = max(reach, b)
        ends.append(reach)
    idle = 0.0
    for a, b in gaps(tr):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid)
        if k and ends[k - 1] >= mid:
            idle += b - a
    return idle / 1e3 / tr.units
