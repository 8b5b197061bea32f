"""The port's tracer: named spans inside the program.

Program code calls `span(name, **attrs)` and nothing else:

    with span("sampler"):
        ...

Off (the default) `span` returns one shared no-op context: it records
nothing, enters no profiler region, and launches and synchronises nothing.

`enable()` turns the tracer on for the process. Each span then records its
name and attributes, its start and end in ns on `time.perf_counter_ns`, its
id, the id of the span open around it on the same thread (None for a
thread's outermost span), the thread's id, and the id of its root. A root
is a span opened while no root is open anywhere in the process
(`train.step`, `render.frame`). A span opened on another thread while a
root is open takes that root, so every span of a step or a frame shares one
root id, those of a backward run on the autograd engine's device thread
included. `take()` returns the finished spans and clears them; `disable()`
turns the tracer off.

While a torch profiler records, an enabled span also opens a
`torch.profiler.record_function` region of its name, so the profile shows
it on its thread beside the launches made inside it. `trace_offset_ns`
maps the span clock onto a profile's: a stamp plus the offset is ns after
the profile's start, the origin of its events' `time_range` (in µs).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    attrs: Dict[str, Any]
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    thread: int
    root: int


_NOOP = contextlib.nullcontext()
_on = False
_lock = threading.Lock()
_done: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()
_root: Optional[int] = None  # the open root's id


class _Open:
    """An enabled span while it is open."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "region", "stack")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _root
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent = None
            if _root is None:
                _root = self.id
            self.root = _root
        stack.append(self)
        self.region = None
        if torch.autograd._profiler_enabled():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _root
        end = time.perf_counter_ns()
        if self.region is not None:
            self.region.__exit__(*exc)
        self.stack.pop()
        if self.root == self.id:
            _root = None
        rec = Span(self.name, self.attrs, self.start, end, self.id, self.parent,
                   threading.get_ident(), self.root)
        with _lock:
            _done.append(rec)
        return False


def span(name: str, /, **attrs):
    """A context that records the enclosed region as a span while the
    tracer is on, and the shared no-op context while it is off. `name` is
    positional only, so an attribute may be called `name` too."""
    if not _on:
        return _NOOP
    return _Open(name, attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> List[Span]:
    """The spans finished since the last take, in the order they ended."""
    global _done
    with _lock:
        out, _done = _done, []
    return out


def trace_offset_ns(prof) -> int:
    """ns to add to a span's stamp to place it on the clock of the finished
    torch.profiler.profile `prof`: ns after the profile's start, which is on
    `time.time_ns`'s clock."""
    start = prof.profiler.kineto_results.trace_start_ns()
    return time.time_ns() - time.perf_counter_ns() - start
