"""The benchmark's frozen arithmetic over a torch.profiler trace.

Device time is summed from the trace's raw kineto events (``key_averages``
spends a fraction of a millisecond of host time on each launch), as the
repository's chip_smoke.py::profile_render sums it.  A device event is a
kernel, a copy or a set on the card.  Its launch is placed on the host's
timeline by the CUDA runtime call of the same correlation id, or, failing
that, by the start of the host operation it is linked to; a launch inside
one of the benchmark's ``record_function`` ranges belongs to that range.
The profiler mirrors each such range onto the card's timeline as an
annotation; those are not device work and are left out.
"""
from __future__ import annotations

import bisect

PREFIX = "perfbench."


def _is_device(e, torch):
    """A kernel, copy or set on the card; not the annotations the profiler
    mirrors onto the card's timeline for each host range."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return (e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0
            and "annotation" not in kind and not e.name().startswith(PREFIX))


def device_events(prof):
    """[(name, start_ns, duration_ns, correlation id, linked host op id)]."""
    import torch

    return [(e.name(), e.start_ns(), e.duration_ns(), e.correlation_id(),
             e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events() if _is_device(e, torch)]


def busy_ns(events):
    """The length of the union of the events' intervals."""
    total, end = 0, None
    for _, s, d, *_ in sorted(events, key=lambda e: e[1]):
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def by_name(events):
    """{name: [seconds, count]}."""
    out = {}
    for name, _, d, *_ in events:
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += d / 1e9
        acc[1] += 1
    return out


def host_ranges(prof):
    """The benchmark's ranges: [(name without the prefix, start_ns, end_ns)]."""
    import torch

    return sorted(((e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CPU
                   and e.name().startswith(PREFIX)), key=lambda r: r[1])


def launch_times(prof):
    """{(correlation id, linked id): host launch time in ns} for every device
    event, and how many were placed by their runtime call, by their linked
    host op, and not at all."""
    import torch

    evs = prof.profiler.kineto_results.events()
    runtime, ops = {}, {}
    for e in evs:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith(("cuda", "cu")) and not name.startswith(PREFIX):
            runtime[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    times, placed = {}, [0, 0, 0]
    for e in evs:
        if not _is_device(e, torch):
            continue
        key = (e.correlation_id(), e.linked_correlation_id())
        if key[0] in runtime:
            times[key] = runtime[key[0]]
            placed[0] += 1
        elif key[1] in ops:
            times[key] = ops[key[1]]
            placed[1] += 1
        else:
            placed[2] += 1
    return times, placed


def range_of(ranges, t):
    """The name of the innermost range holding host time t, or None."""
    starts = [r[1] for r in ranges]
    i = bisect.bisect_right(starts, t)
    best = None
    for name, s, e in ranges[max(0, i - 64):i]:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s, e)
    return None if best is None else best[0]


def device_ns_by_range(prof, events):
    """{range name or None: device ns of the events launched inside it}."""
    ranges = host_ranges(prof)
    times, placed = launch_times(prof)
    out = {}
    for _, _, d, corr, linked in events:
        t = times.get((corr, linked))
        name = None if t is None else range_of(ranges, t)
        out[name] = out.get(name, 0) + d
    return out, placed


def idle_gaps(events, ranges, start_ns, end_ns, traversal=("intersect", "any_hit")):
    """The device's idle intervals inside [start_ns, end_ns], each labelled by
    what the host was doing at its middle: a traversal range, the frame's
    set-up before the first of them, its end after the last, and shading
    between -> [(label, seconds)], longest first."""
    trav = [r for r in ranges if r[0] in traversal]
    first = trav[0][1] if trav else end_ns
    last = trav[-1][2] if trav else start_ns
    gaps, cursor = [], start_ns
    for _, s, d, *_ in sorted(events, key=lambda e: e[1]):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, s + d)
    if end_ns > cursor:
        gaps.append((cursor, end_ns))
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        name = range_of(trav, mid)
        if name is None:
            name = "frame_setup" if mid < first else "frame_end" if mid > last else "shading"
        out.append((name, (b - a) / 1e9))
    return sorted(out, key=lambda g: -g[1])
