"""Shared arithmetic of the per-layer metrics (`metrics/<name>.py`).  Each
returns None where it finds nothing to read, and the harness then leaves
the metric out of the result line; a share of a roofline or of a peak is
never reported as 0 for want of a reading."""

from __future__ import annotations

from typing import Optional

from perfbench import work


def host_ms_per_unit(r, span: str) -> Optional[float]:
    s = r.spans_s.get(span)
    return None if s is None or r.units == 0 else 1e3 * s / r.units


def launches_per_unit(r) -> Optional[float]:
    return None if r.units == 0 else sum(r.launches.values()) / r.units


def nonmlp_device_ms(r) -> Optional[float]:
    tr = r.trace
    if tr is None or tr.units == 0:
        return None
    mlp = tr.role_us(r.roles.get("mlp_fwd", [])) + tr.role_us(r.roles.get("mlp_bwd", []))
    return (tr.total_us() - mlp) / 1e3 / tr.units


def roofline(r, role: str) -> Optional[float]:
    """Per cent of the least time of the role's work in the traced slice
    against the device time of the kernels that role's maps name."""
    tr = r.trace
    if tr is None or tr.units == 0:
        return None
    us = tr.role_us(r.roles.get(role, []))
    flop, nbytes = (r.work["fwd_flop"], r.work["fwd_bytes"]) if role == "mlp_fwd" else (
        r.work["bwd_flop"], r.work["bwd_bytes"])
    if us <= 0 or flop <= 0:
        return None
    return work.roofline_share(flop * tr.units, nbytes * tr.units, us / 1e6, r.dtype)


def device_idle(r) -> Optional[float]:
    """Per cent of the untraced window's time a unit in which no operation
    ran on the device: 1 - (the traced slice's busy time a unit) / (the
    window's seconds a unit).  The profiler adds host time to each launch
    and so stretches a host-held slice, not the device's work; the slice's
    own span would count that stretch as idle."""
    tr = r.trace
    if tr is None or tr.units == 0 or r.units == 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - (tr.busy_us / 1e6 / tr.units) / (r.window_s / r.units))


def peak_gb(r) -> Optional[float]:
    return r.peak_window_bytes / 1e9 if r.peak_window_bytes > 0 else None


def mfu(r) -> Optional[float]:
    """The window's model FLOP over its seconds, per cent of the peak."""
    if r.units == 0 or r.window_s <= 0:
        return None
    return 100.0 * r.work["model_flop"] * r.units / r.window_s / work.PEAK_FLOPS[r.dtype]
