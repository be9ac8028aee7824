"""The port's tracer: spans and counters of each frame, measured where the
work happens.

``with span(name, **attrs):`` records a span: its name, id, parent's id,
frame id, attributes, and its host start and end from ``time.time_ns()``
(the epoch clock that torch.profiler's kineto events carry, so a span lines
up with an exported device trace).  Inside a frame on a CUDA device a span
also records a CUDA event pair on the current stream, its device interval
(from a pool of events: making one costs the host more than recording it);
while a torch.profiler session records, it also enters a profiler range
``pine.<name>`` (a cpu_op range, ``_range``), so an exported trace puts every
launch and idle gap under the program stage whose host work was running.

Tracing is on while ``enable()`` holds (the CLI's ``--trace``), or when a
torch.profiler session is recording as a frame starts (``frame()``: the
integrators' ``render``).  It is decided once per frame and kept until the
next frame starts, so the film's readback after ``render`` returns counts
toward the frame it reads.  When off, ``span()`` returns one shared no-op
context after a single flag test: it records, launches and synchronises
nothing.

Counters add up per frame (``count``): host numbers as they come, 0-d
device tensors by reference.  ``sync(site)`` is a span ``sync.<site>``
around one host-device synchronisation on the card, and nothing else, and
adds 1 to the counter ``syncs`` (``to_device`` puts a copy from pageable
memory in one); it takes host times only, no event pair and no range.  A
traversal group's ``group.<route>`` span (``group_span``) takes a range but
no event pair.  Each span also keeps the host time the tracer spent on it
outside its own interval (``own_ns``: the event records, the range, the
bookkeeping), which lies inside its parent's.
The frame's kernel launches by route come from the launch counters that
``launch_counter`` was given (``accel/dense_traverse.py``'s ``LAUNCHES``,
``integrators/ao.py``'s; ``launches.<route>.<form>``).  CUDA event pairs
and device counters are resolved only when the record is read
(``frames``, ``first_frame``, ``export``, ``tree``), never inside a frame.

The record keeps the spans of the last ``KEEP`` frames, the first frame
recorded in the process, and the set-up spans (those outside any frame).
A frame's record (``Frame.record``) is a plain dict: ``id``, ``attrs``,
``t0_ns``, ``t1_ns``, ``counters`` ({name: number}) and ``spans``, each
{name, id, parent, frame, attrs, t0_ns, t1_ns, own_ns, device_ms (None off
the card)}.
"""
from __future__ import annotations

import collections
import itertools
import json
import time

import torch

KEEP = 4  # frames whose spans are kept
SETUP_KEEP = 4096  # set-up spans kept
POOL_MIN = 1024  # CUDA events made ahead of a traced frame, at least
PREFIX = "pine."  # torch.profiler range prefix
TRAILING = ("film.readback",)  # root spans after a frame that count toward it

_enabled = False  # enable() holds
_on = False  # the current frame's decision (set-up: _enabled)
_cuda = False  # the current frame runs on a CUDA device
_ranges = False  # the current frame enters torch.profiler ranges
_frame = None  # the current (or last) Frame, while tracing
_open_frame = False  # a frame span is open
_stack = []  # open spans
_ids = itertools.count(1)
_frame_ids = itertools.count(0)
_frames = collections.deque(maxlen=KEEP)
_first = None
_setup = collections.deque(maxlen=SETUP_KEEP)
_pool = []  # resolved CUDA events, recorded again by later spans
_launches = []  # the launch counters' storage: dicts {route.form: launches so far}


class _NoSpan:
    """The shared no-op context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


def _event():
    """A timing CUDA event, from the pool of resolved ones where it has one
    (creating one costs the host more than recording it)."""
    if _pool:
        return _pool.pop()
    return torch.cuda.Event(enable_timing=True)


def _range(name):
    """The torch.profiler range of a span.  A cpu_op range: a
    record_function range is a user annotation, which kineto mirrors onto the
    card's timeline as a device event of its own, and a reader of device
    events that does not drop those would count it as device work."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        raise RuntimeError("this torch has no _RecordFunctionFast: the spans cannot enter "
                           "torch.profiler ranges")
    return fast(PREFIX + name)


class Span:
    __slots__ = ("name", "id", "parent", "frame", "attrs", "t0", "t1", "own", "ev", "device_ms",
                 "_rf", "_kind")

    def __init__(self, name, attrs, kind=2):
        self.own = time.time_ns()  # until __enter__ sets t0: the span's making
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = self.frame = None
        self.t0 = self.t1 = 0
        self.ev = self.device_ms = self._rf = None
        self._kind = kind  # 2: a device interval and a range; 1: a range; 0: host times alone

    def __enter__(self):
        parent = self.parent = _stack[-1] if _stack else None
        if parent is not None and parent.frame is not None:
            self.frame = parent.frame
        elif _open_frame or self.name in TRAILING:
            self.frame = _frame
        (_setup if self.frame is None else self.frame.spans).append(self)
        _stack.append(self)
        if self._kind and _ranges:
            self._rf = _range(self.name)
            self._rf.__enter__()
        if self._kind == 2 and _cuda and self.frame is not None:
            self.ev = (_event(), _event())
            self.ev[0].record()
            self.frame.n_events += 2
        self.t0 = time.time_ns()
        self.own = self.t0 - self.own
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.ev is not None:
            self.ev[1].record()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _stack.pop()
        self.own += time.time_ns() - self.t1
        return False

    def resolve(self):
        """The device interval from the event pair (synchronises on its end);
        the pair goes back to the pool."""
        if self.ev is not None:
            self.ev[1].synchronize()
            self.device_ms = self.ev[0].elapsed_time(self.ev[1])
            _pool.extend(self.ev)
            self.ev = None

    def record(self):
        return dict(name=self.name, id=self.id, parent=self.parent and self.parent.id,
                    frame=self.frame and self.frame.id, attrs=self.attrs, t0_ns=self.t0,
                    t1_ns=self.t1, own_ns=self.own, device_ms=self.device_ms)


class Frame:
    """One frame's spans and counters."""

    def __init__(self, fid, attrs):
        self.id, self.attrs = fid, attrs
        self.spans, self.counters = [], {}
        self.t0 = self.t1 = 0
        self.n_events = 0
        self._launches = None

    def resolve(self):
        for s in self.spans:
            s.resolve()
        for k, v in self.counters.items():
            if isinstance(v, list):  # 0-d device tensors and host numbers
                self.counters[k] = sum(x if isinstance(x, (int, float)) else x.item() for x in v)

    def drop(self):
        """Its spans' pending event pairs back to the pool, unread."""
        for s in self.spans:
            if s.ev is not None:
                _pool.extend(s.ev)
                s.ev = None

    def record(self):
        self.resolve()
        return dict(id=self.id, attrs=self.attrs, t0_ns=self.t0, t1_ns=self.t1,
                    counters=dict(self.counters), spans=[s.record() for s in self.spans])


class _FrameSpan:
    """The ``frame`` span: opens a Frame, and closes it with the launches it
    made."""

    __slots__ = ("fr", "sp")

    def __init__(self, fr):
        self.fr = fr
        self.sp = Span("frame", fr.attrs)

    def __enter__(self):
        global _open_frame
        fr = self.fr
        fr._launches = _launch_totals()
        _open_frame = True
        self.sp.__enter__()
        fr.t0 = self.sp.t0
        return self.sp

    def __exit__(self, *exc):
        global _open_frame
        self.sp.__exit__(*exc)
        _open_frame = False
        fr = self.fr
        fr.t1 = self.sp.t1
        for k, v in _launch_totals().items():
            if v != fr._launches.get(k, 0):
                fr.counters["launches." + k] = v - fr._launches.get(k, 0)
        return False


def _profiler_recording():
    return torch._C._autograd._profiler_enabled()


def frame(device=None, /, **attrs):
    """The ``frame`` span of one render on ``device`` (None: the card).
    Decides whether this frame is traced."""
    global _on, _cuda, _ranges, _frame, _first
    fid = next(_frame_ids)
    ranges = _profiler_recording()
    _on = _enabled or ranges
    if not _on:
        return NOOP
    _ranges = ranges
    _cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if _cuda:
        need = max(POOL_MIN, _frame.n_events if _frame is not None else 0)
        while len(_pool) < need:  # made before the frame's spans start
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            _pool.append(ev)
    if len(_frames) == KEEP and _frames[0] is not _first:
        _frames[0].drop()
    _frame = Frame(fid, attrs)
    _frames.append(_frame)
    if _first is None:
        _first = _frame
    return _FrameSpan(_frame)


def span(name, /, **attrs):
    """A span of ``name`` with ``attrs`` (module docstring)."""
    if not _on:
        return NOOP
    return Span(name, attrs)


def sync(site):
    """The span ``sync.<site>`` around one host-device synchronisation and
    nothing else (its time is the wait for the card), added to the counter
    ``syncs``; nothing off the card, where it is no synchronisation."""
    if not (_on and _cuda):
        return NOOP
    count("syncs", 1)
    return Span("sync." + site, {}, kind=0)


def to_device(x, device, site, dtype=None):
    """``torch.as_tensor(x, dtype, device)``: on the card a copy from pageable
    memory, which synchronises, so when traced it sits in a ``sync.<site>``
    span of its own."""
    if not (_on and _cuda):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with sync(site):
        return torch.as_tensor(x, dtype=dtype, device=device)


def group_span(route):
    """The span ``group.<route>`` of one traversal group's query: a range
    and host times, no device interval (an event pair costs the host about
    as much as a launch; the ``intersect`` or ``any_hit`` call holding it has
    one)."""
    if not _on:
        return NOOP
    return Span("group." + route, {}, kind=1)


def count(name, value, suffix=None):
    """Add ``value`` (a number, or a 0-d device tensor kept by reference) to
    the counter ``name`` (``name + str(suffix)``) of the frame of the
    innermost open span; outside a frame, nothing."""
    if not _on or not _stack or _stack[-1].frame is None:
        return
    if suffix is not None:
        name = f"{name}{suffix}"
    c = _stack[-1].frame.counters
    prev = c.get(name, 0)
    if isinstance(prev, list):
        prev.append(value)
    elif isinstance(value, (int, float)):
        c[name] = prev + value
    else:
        c[name] = [prev, value]


def launch_counter(counts):
    """Read each frame's kernel launches from ``counts`` too ({route.form:
    launches so far}, kept up to date by the module that launches them)."""
    _launches.append(counts)


def _launch_totals():
    return {k: v for c in _launches for k, v in c.items()}


def enable():
    """Trace every frame from now on, and the set-up spans."""
    global _enabled, _on
    _enabled = _on = True


def disable():
    global _enabled, _on
    _enabled = _on = False


def reset():
    """Forget every recorded span and frame (tracing stays as it is)."""
    global _frame, _first, _open_frame
    _frames.clear()
    _setup.clear()
    _stack.clear()
    _frame = _first = None
    _open_frame = False


def frames():
    """The records of the kept frames, oldest first."""
    return [f.record() for f in _frames]


def first_frame():
    """The record of the first frame recorded in the process, or None."""
    return None if _first is None else _first.record()


def setup_spans():
    return [s.record() for s in _setup]


def _records():
    """(every kept frame's record, the first frame's included, every kept span's)."""
    recs = ([first_frame()] if _first is not None and _first not in _frames else []) + frames()
    return recs, setup_spans() + [s for r in recs for s in r["spans"]]


def trace_events():
    """Chrome trace-event objects: an ``X`` event per span (µs of the epoch
    clock; the device interval in its args) and a ``C`` event per counter of
    each frame, at the frame's start."""
    out = []
    recs, spans = _records()
    for s in spans:
        args = dict(s["attrs"], id=s["id"], parent=s["parent"], frame=s["frame"],
                    own_ns=s["own_ns"])
        if s["device_ms"] is not None:
            args["device_ms"] = s["device_ms"]
        out.append(dict(name=s["name"], ph="X", ts=s["t0_ns"] / 1e3,
                        dur=(s["t1_ns"] - s["t0_ns"]) / 1e3, pid=0, tid=0, args=args))
    for r in recs:
        for k, v in sorted(r["counters"].items()):
            out.append(dict(name=k, ph="C", ts=r["t0_ns"] / 1e3, pid=0, args={"value": v}))
    return out


def export(path):
    """Write the record as Chrome trace-event JSON to ``path``."""
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events(), "displayTimeUnit": "ms"}, f)


def tree():
    """The span tree of the record: per path of names, calls, host ms, host
    self ms (less the children's host time and the tracer's own on them) and
    device ms -> lines."""
    _, spans = _records()
    by_id = {s["id"]: s for s in spans}
    child_ns = collections.Counter()
    for s in spans:
        if s["parent"] in by_id:
            child_ns[s["parent"]] += s["t1_ns"] - s["t0_ns"] + s["own_ns"]
    rows = {}
    for s in spans:
        path, p = [s["name"]], s
        while p["parent"] in by_id:
            p = by_id[p["parent"]]
            path.append(p["name"])
        acc = rows.setdefault(tuple(reversed(path)), [0, 0, 0, 0.0, False])
        host = s["t1_ns"] - s["t0_ns"]
        acc[0] += 1
        acc[1] += host
        acc[2] += host - child_ns[s["id"]]
        if s["device_ms"] is not None:
            acc[3] += s["device_ms"]
            acc[4] = True
    lines = [f"{'span':<40} {'calls':>7} {'host ms':>10} {'self ms':>10} {'device ms':>10}"]

    def emit(prefix):
        kids = [p for p in rows if len(p) == len(prefix) + 1 and p[:len(prefix)] == prefix]
        for p in sorted(kids, key=lambda p: -rows[p][1]):
            n, host, self_ns, dev, has_dev = rows[p]
            name = "  " * len(prefix) + p[-1]
            dev_s = f"{dev:10.3f}" if has_dev else f"{'-':>10}"
            lines.append(f"{name:<40} {n:>7} {host / 1e6:10.3f} {self_ns / 1e6:10.3f} {dev_s}")
            emit(p)

    emit(())
    return lines
