"""Spans and counts of the port's layers, recorded in traced runs.

A span is one interval of one layer: its name, its start and end in
nanoseconds of ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux: one
clock for a process and its pool's workers, and the clock of
``time.perf_counter()``), the span that holds it, the request it serves
(one CLI command; a pool worker's spans carry its parent's), the process,
a dict of counts taken at the same boundary (members, windows, segments,
bytes, hits, ...) and the kernels launched under it: for each launcher
prefix of ``ops/_cuda.py``, the launches and their device seconds from a
pair of CUDA events on the launch's stream.

The recorder is off unless a torch.profiler session is active in the
process when a CLI command starts (``request``).  Off, a span site costs a
flag test: ``span`` hands back one shared do-nothing context, ``count``
returns at once and a bound launcher calls its kernel straight.  On, spans
go to a bounded buffer in memory; in a process with a profiler session
each span is also a ``record_function`` range, so an exported trace shows
it beside the device activity.  A worker of the run's pool takes the
request from its parent (``worker_state`` -> ``adopt``) and hands its
spans back in its report (``take`` -> ``merge``).

    with trace.span("scan.encode"):
        trace.count("bytes", n)
        ...

``spans()`` reads the buffer; ``chrome(spans)`` turns spans into a Chrome
trace (``run --profile DIR`` writes ``DIR/spans.json``).
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import time

# tested at every span, count and launch site
ON = False
# spans kept, the oldest dropped past it (a traced `run` job records some
# thousands)
MAX_SPANS = 1 << 17


class _Recorder:
    def __init__(self):
        self.spans = collections.deque(maxlen=MAX_SPANS)
        self.stack = []              # open spans of this process
        self.request = None          # the open request's id
        self.profiled = False        # a profiler session in this process
        self.parent = None           # a worker's: its parent's fan-out span
        self.t_pool = None           # a worker's: when its pool was made
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)


_rec = _Recorder()


def _cuda_events(handle):
    """Two timing events and the stream a launch names by its handle."""
    import torch
    stream = torch.cuda.current_stream()
    if stream.cuda_stream != handle:
        stream = torch.cuda.ExternalStream(handle)
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True), stream)


# (start event, end event, stream) for a stream handle; tests stand in a
# stub for the CUDA events
EVENTS = _cuda_events


class _Off:
    """The context every span site gets while the recorder is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "counts", "kernels",
                 "pending", "_range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        rec = _rec
        self.parent = rec.stack[-1].id if rec.stack else rec.parent
        self.id = "%d.%d" % (os.getpid(), next(rec.ids))
        self.counts, self.kernels, self.pending = {}, {}, []
        self._range = None
        if rec.profiled:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        rec.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = _rec
        rec.stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        for prefix, a, b in self.pending:
            b.synchronize()
            k = self.kernels.setdefault(prefix, [0, 0.0])
            k[0] += 1
            k[1] += a.elapsed_time(b) / 1e3
        rec.spans.append({"name": self.name, "id": self.id,
                          "parent": self.parent, "request": rec.request,
                          "pid": os.getpid(), "start": self.start,
                          "end": end, "counts": self.counts,
                          "kernels": self.kernels})
        return False


class _Request(_Span):
    """The root span of a CLI command, which turns the recorder on."""

    __slots__ = ()

    def __enter__(self):
        global ON
        _rec.request = "%d.%d" % (os.getpid(), next(_rec.requests))
        _rec.profiled = True
        ON = True
        return super().__enter__()

    def __exit__(self, *exc):
        global ON
        try:
            super().__exit__(*exc)
        finally:
            ON = False
            _rec.request = None
            _rec.profiled = False
        return False


def _profiling():
    """Whether a torch.profiler session is active in this process (none
    can be where torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def request(name):
    """The context of one CLI command: its root span, and the recorder on
    for its length, where a torch.profiler session is active; inside an
    open request, a span."""
    if ON:
        return _Span(name)
    if not _profiling():
        return _OFF
    return _Request(name)


def span(name):
    """The context of one span named ``name`` under the innermost open
    one."""
    if not ON:
        return _OFF
    return _Span(name)


def count(key, n=1):
    """Adds ``n`` to the count ``key`` of the innermost open span."""
    if ON and _rec.stack:
        counts = _rec.stack[-1].counts
        counts[key] = counts.get(key, 0) + n


def launch(prefix, fn, args):
    """Calls a bound kernel launcher (``args`` end with its stream handle)
    between two events on that stream, for the innermost open span to
    read at its end: ``ops/_cuda.py`` calls it while the recorder is on."""
    top = _rec.stack[-1] if _rec.stack else None
    if top is None:
        return fn(*args)
    start, end, stream = EVENTS(args[-1])
    start.record(stream)
    rc = fn(*args)
    end.record(stream)
    top.pending.append((prefix, start, end))
    return rc


def worker_state():
    """What a pool worker needs to record for the open request: (request,
    the innermost open span, now), or None while the recorder is off."""
    if not ON:
        return None
    return (_rec.request, _rec.stack[-1].id if _rec.stack else None,
            time.perf_counter_ns())


def adopt(state):
    """In a pool worker: record for the parent's request (``state`` from
    ``worker_state``), from an empty buffer; None leaves the recorder
    off."""
    global ON
    _rec.spans.clear()
    _rec.stack = []
    _rec.profiled = False
    if state is None:
        ON = False
        _rec.request = _rec.parent = _rec.t_pool = None
        return
    _rec.request, _rec.parent, _rec.t_pool = state
    ON = True


def worker_started():
    """In a pool worker, as its first cluster begins: records
    ``worker.start``, from the pool's creation until now (once)."""
    if not ON or _rec.t_pool is None:
        return
    _rec.spans.append({"name": "worker.start",
                       "id": "%d.%d" % (os.getpid(), next(_rec.ids)),
                       "parent": _rec.parent, "request": _rec.request,
                       "pid": os.getpid(), "start": _rec.t_pool,
                       "end": time.perf_counter_ns(), "counts": {},
                       "kernels": {}})
    _rec.t_pool = None


def take():
    """The spans this process recorded since the last take, the buffer
    emptied: what a pool worker hands back with a report."""
    out = list(_rec.spans)
    _rec.spans.clear()
    return out


def merge(spans):
    """Adds spans a worker handed back to this process's buffer."""
    _rec.spans.extend(spans)


def spans(request=None):
    """The recorded spans (dicts), oldest first; of one request if
    given.  Reading changes nothing."""
    return [s for s in _rec.spans
            if request is None or s["request"] == request]


def last_request():
    """The id of the newest request with a span in the buffer, or None."""
    for s in reversed(_rec.spans):
        if s["request"] is not None:
            return s["request"]
    return None


def chrome(spans):
    """Spans -> a Chrome trace (``chrome://tracing``, Perfetto): one
    complete event a span, a pid a process, timestamps in microseconds of
    perf_counter_ns, the counts and each launcher's launches and kernel
    seconds as args."""
    events = []
    for pid in sorted({s["pid"] for s in spans}):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": pid, "args": {"name": "pid %d" % pid}})
    for s in spans:
        args = {"request": s["request"], "id": s["id"],
                "parent": s["parent"], **s["counts"]}
        for prefix, (n, secs) in s["kernels"].items():
            args["kernel." + prefix] = {"launches": n, "s": secs}
        events.append({"ph": "X", "name": s["name"], "cat": "span",
                       "pid": s["pid"], "tid": s["pid"],
                       "ts": s["start"] / 1e3,
                       "dur": (s["end"] - s["start"]) / 1e3, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "time.perf_counter_ns / 1000 "
                                   "(CLOCK_MONOTONIC), microseconds"}}
