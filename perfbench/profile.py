"""Reading a ``torch.profiler`` trace of the measured window.

The device side is every event the profiler records on the card (kernels,
copies, fills), as ``chip_smoke.py::profile_top`` sums them by name; the
host side is every CPU event (operators, CUDA runtime calls, the
benchmark's own ``record_function`` spans), used to say what the host was
doing while the card sat idle.  Times are seconds on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

WINDOW_SPAN = "perfbench.window"


@dataclasses.dataclass
class Trace:
    window: tuple  # (start, end) of the traced window
    device: list  # (name, start, duration), device events inside the window
    host_names: list
    host_start: np.ndarray
    host_end: np.ndarray


def _times(ev):
    if hasattr(ev, "start_ns"):
        return ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    return ev.start_us() * 1e-6, ev.duration_us() * 1e-6


def _annotation(ev) -> bool:
    """A user annotation that the profiler draws on the device's timeline."""
    check = getattr(ev, "is_user_annotation", None)
    return bool(check()) if check is not None else False


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the body (CPU and CUDA activities) when ``enabled``; the
    ``Trace`` is left in ``out["trace"]``."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=False) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
    out["trace"] = parse(prof)


def parse(prof) -> Trace:
    """Split the profiler's raw events into device and host events."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device, names, starts, ends, window = [], [], [], [], None
    for ev in events:
        start, dur = _times(ev)
        if ev.device_type() == cuda:
            if not _annotation(ev):
                device.append((ev.name(), start, dur))
        elif ev.name() == WINDOW_SPAN:
            window = (start, start + dur)
        else:
            names.append(ev.name())
            starts.append(start)
            ends.append(start + dur)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    # a host range (record_function, a collective's name) is also drawn on
    # the device's timeline; a device operation never shares a host event's name
    host = set(names) | {WINDOW_SPAN}
    device = [d for d in device if d[1] < hi and d[1] + d[2] > lo and d[0] not in host]
    return Trace(window=window, device=device, host_names=names,
                 host_start=np.asarray(starts), host_end=np.asarray(ends))


def busy_intervals(trace: Trace) -> list:
    """The union of the device events, clipped to the window, in order."""
    lo, hi = trace.window
    spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in trace.device)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(trace: Trace) -> float:
    return float(sum(e - s for s, e in busy_intervals(trace)))


def device_seconds(trace: Trace) -> float:
    """Sum of the device events' durations (overlaps counted twice)."""
    return float(sum(d for _, _, d in trace.device))


def top_device_ops(trace: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the device events that took most time."""
    by_name = {}
    for name, _, d in trace.device:
        by_name[name] = by_name.get(name, 0.0) + d
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], secs] for name, secs in ranked]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[[host activity, seconds]] of the longest stretches of the window with
    no device event, each named by the innermost host event open at its
    start (the latest-starting CPU event that covers it)."""
    lo, hi = trace.window
    gaps, cursor = [], lo
    for s, e in busy_intervals(trace):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in gaps:
        t = g0 + min(1e-6, (g1 - g0) / 2)
        open_ = np.nonzero((trace.host_start <= t) & (trace.host_end > t))[0]
        if open_.size:
            inner = open_[np.argmax(trace.host_start[open_])]
            label = trace.host_names[inner]
        else:
            label = "host (no event)"
        out.append([label[:160], g1 - g0])
    return out


def seconds_by_layer(trace: Trace, layers: list) -> dict:
    """Device seconds by layer: each event goes to the first (layer,
    substrings) entry one of whose substrings its name holds, else 'other'."""
    out = {}
    for name, _, d in trace.device:
        layer = next((lay for lay, keys in layers if any(k in name for k in keys)), "other")
        out[layer] = out.get(layer, 0.0) + d
    return out
