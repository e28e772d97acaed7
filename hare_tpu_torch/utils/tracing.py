"""Spans and counters inside the program: where its host time goes.

- :func:`span` marks a phase of the program (``with span("hare.bounce",
  b=2): ...``); :func:`spanned` puts a whole function's call in one.  Off
  by default: it then returns one shared object that does nothing, reads
  no clock and touches no torch state, so the spans left in the main path
  cost a function call each.
- :func:`enable` turns recording on.  Each span is then kept in memory as
  a :class:`Span` on ``time.perf_counter_ns``, with its parent (the span
  open on the same thread when it began) and its request id: given as the
  ``id`` attribute, else its parent's, else, at the top of its thread, its
  own sequence number.  So every span of one ``trace_rays`` call carries
  that call's id, and an autograd backward, which runs on another thread,
  passes the id its forward saved.
- While a ``torch.profiler`` session is running, a recorded span also opens
  a record function of its name, so it lands in the profiler's trace beside
  the device's kernels and copies, on the profiler's clock.  It is the
  profiler's fast form (``_RecordFunctionFast``, a function's scope, not a
  user annotation), so the device's side of the trace holds no copy of it
  and a span costs about a microsecond more, not ten.
- :func:`count` adds to a named counter, whether recording is on or off:
  ``launches.<C entry point>`` (``kernels.build.launch``), ``syncs.<site>``
  (each blocking read of a step, by :func:`sync`), ``rays.shot`` (rays
  handed to a traversal), ``rays.ordered`` (those K1 took in its ray order),
  ``kernels.builds``, and ``histogram_bwd.hard`` /
  ``.soft`` (the mode of each ``hare_histogram_bwd`` launch).  :data:`counters` is the live
  table; a path that counts every launch adds to it in place, which costs
  what a function attribute's increment does, where a call costs more.
- :func:`snapshot` returns what was recorded since :func:`reset`.

Nothing is written anywhere: readers take the snapshot or the profiler's
trace.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Snapshot", "Span", "count", "counters", "current_id", "disable", "enable", "enabled",
           "reset", "snapshot", "span", "spanned", "sync"]


class Span(NamedTuple):
    """One finished span."""

    seq: int  # order of opening, from 1
    name: str
    attrs: dict  # its attributes, ``id`` always among them
    parent: Optional[int]  # seq of the span open on its thread when it began
    thread: int  # threading.get_ident() of the thread it ran on
    start_ns: int  # time.perf_counter_ns()
    end_ns: int


class Snapshot(NamedTuple):
    spans: List[Span]  # finished spans, in the order they were opened
    counters: Dict[str, int]


_on = False
_spans: List[Span] = []
counters: Dict[str, int] = defaultdict(int)
_seq = itertools.count(1)
_local = threading.local()
# What a recorded span opens while the profiler runs.
_record_function = torch._C._profiler._RecordFunctionFast


class _Off:
    """What :func:`span` returns while recording is off: one shared object
    whose enter and exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "seq", "parent", "stack", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.seq = next(_seq)
        self.parent = None if top is None else top.seq
        if self.attrs.get("id") is None:
            self.attrs["id"] = self.seq if top is None else top.attrs["id"]
        self.stack = stack
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        _spans.append(Span(self.seq, self.name, self.attrs, self.parent, threading.get_ident(),
                           self.start, end))
        return None


def span(name: str, **attrs):
    """A context manager marking the phase ``name``; recorded only while
    recording is on (:func:`enable`)."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def sync(site: str):
    """The span ``hare.sync`` of a read that blocks the host until the
    device has caught up, at ``site``; counted under ``syncs.<site>``."""
    counters["syncs." + site] += 1
    return span("hare.sync", site=site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    counters[name] += n


def current_id() -> Optional[int]:
    """The request id of the span open on this thread (None where recording
    is off or no span is open): what an autograd Function's forward keeps
    for the spans of its backward."""
    if not _on:
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1].attrs["id"] if stack else None


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def snapshot() -> Snapshot:
    """The spans finished and the counts made since the last :func:`reset`."""
    return Snapshot(sorted(_spans), dict(counters))


def reset() -> None:
    """Forget every span and count recorded so far."""
    del _spans[:]
    counters.clear()
