"""Profiler traces, named spans and the port's launch counter.

Counterpart of ``mirage_tpu/utils/profiling.py`` on ``torch.profiler``:
:func:`trace` writes a Chrome trace of the host and, where a card is
present, the device into a directory (TensorBoard's and Perfetto's format),
and beside it ``spans.json``, the :func:`summary` of the spans recorded in
the block; it does nothing for no directory. :func:`annotate` names a span.

Spans record only while a ``torch.profiler`` profile is active (this
module's :func:`trace`, the benchmark's traced window, or any
``torch.profiler.profile``). With none active, :func:`annotate` reads the
profiler's enabled flag and returns one shared no-op context manager: no
``record_function``, no clock, no allocation. While one is active, a span
opens a ``record_function`` range (shown in the exported trace above the
device's kernels) and appends its :class:`Span` to an in-memory list
of at most :data:`LIMIT` records (the rest are counted in
:func:`dropped`): its name, start and end on ``time.time_ns()`` (the clock
of the profiler's timestamps), its parent's index in the list (-1 for a
root), a call id shared by every span under one root, its thread, and the
port's kernel launches counted to it. ``ops/runtime.py:_launch`` calls
:func:`launched` for every launch of a ``csrc/`` entry: while a span is
open it counts toward the innermost span open on the launching thread,
or, from a thread with none (the autograd engine's device threads), toward
the innermost span open in the process. A thread that works for a span
open on another (the serving mesh's replica threads) runs under
:func:`adopt`, so that its spans are that span's children, in its call.

The list holds every span recorded since the last :func:`reset`, which
:func:`trace` calls when it opens. A caller that opens its own
``torch.profiler`` session and reads :func:`summary` calls :func:`reset`
before it; without one, sessions add up, and once :data:`LIMIT` spans are
kept the rest are dropped.

The port's spans, all named ``mirage.<part>``: a training step
(``train/steps.py``) is ``mirage.step`` over ``mirage.forward`` (the
model's forward, ``models/mirage.py``: ``mirage.encoder`` and
``mirage.decoders`` under it), ``mirage.loss``, ``mirage.backward`` and
``mirage.optimizer``; a wrapper call (``api/wrapper.py``) is
``mirage.request`` over ``mirage.inputs`` and ``mirage.forward``; the
pretraining CLI's wait on its loader and the copy to the device is
``mirage.data``. The optimizer's update :func:`tally`s to
``mirage.optimizer`` the leaves and elements of each route
(``table_leaves``, ``table_elems``, ``foreach_leaves``, ``foreach_elems``;
``ref_leaves``, ``ref_elems`` on the CPU) and each leaf table it builds
(``table_builds``, ``ops/fused_adamw.py``). No span name may start with
``cuda`` or ``cu`` and a capital: trace readers take such names for CUDA
runtime calls.
"""

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

# records the list keeps; further spans are counted and not kept
LIMIT = 1 << 16

_OFF = contextlib.nullcontext()
_records: List["Span"] = []
_dropped = 0
_open: List["Span"] = []  # every thread's open spans, in the order opened
_local = threading.local()
_lock = threading.Lock()
_call_ids = itertools.count()


class Span:
    """One span: the context manager :func:`annotate` returns while the
    profiler is active, and its record: ``name``, ``start_ns`` and
    ``end_ns`` (None while open), ``parent`` (its parent's index in
    :func:`records`, -1 for a root), ``call`` (shared by every span under
    one root), ``thread``, ``launches`` (the port's launches counted to
    it, none of its children's) and ``counts`` (what :func:`tally` added
    to it, or None)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "thread",
                 "launches", "counts", "index", "_range")

    def __init__(self, name):
        self.name = name
        self.start_ns = self.end_ns = None
        self.launches, self.counts = 0, None
        self.index = -1

    def __enter__(self):
        global _dropped
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.index if up else -1
        self.call = up.call if up else next(_call_ids)
        self.thread = threading.get_ident()
        with _lock:
            if len(_records) < LIMIT:
                self.index = len(_records)
                _records.append(self)
            else:
                _dropped += 1
            _open.append(self)
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        _stack().pop()
        with _lock:
            _open.remove(self)
        return False


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def annotate(name: str):
    """The span ``name`` as a context manager: recorded (and a
    ``record_function`` range) while a ``torch.profiler`` profile is
    active, else the shared no-op."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return Span(name)


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def adopt(span: Optional[Span]):
    """Runs the block on this thread under ``span``, open on another
    thread (from :func:`current` there): the spans the block opens are its
    children, in its call, and its launches count toward it. None (no span
    open there) adopts nothing."""
    if span is None:
        yield
        return
    stack = _stack()
    stack.append(span)
    try:
        yield
    finally:
        stack.pop()


def launched():
    """Counts one kernel launch toward the innermost span open on this
    thread, else toward the innermost span open in the process; nothing
    when no span is open."""
    if not _open:
        return
    stack = getattr(_local, "stack", None)
    with _lock:
        span = stack[-1] if stack else (_open[-1] if _open else None)
        if span is not None:
            span.launches += 1


def tally(**counts):
    """Adds ``counts`` (name -> number) to the innermost span open on this
    thread; nothing when none is open (no profiler active)."""
    span = current()
    if span is None:
        return
    if span.counts is None:
        span.counts = {}
    for k, v in counts.items():
        span.counts[k] = span.counts.get(k, 0) + v


def records() -> List[Span]:
    """The spans recorded since the last :func:`reset`, in opening order."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept since the last :func:`reset` (the list was full)."""
    return _dropped


def reset():
    """Forgets the recorded spans and the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def _covered(span, children):
    """ns of ``span``'s interval that the intervals of ``children`` cover."""
    ns, end = 0, span.start_ns
    for c in sorted(children, key=lambda c: c.start_ns):
        lo, hi = max(c.start_ns, end), min(c.end_ns, span.end_ns)
        if hi > lo:
            ns += hi - lo
            end = hi
    return ns


def summary() -> Dict[str, Dict]:
    """Span name -> {"calls", "total_ms", "self_ms", "launches", "counts"}
    over the closed spans of :func:`records`: ``self_ms`` is each span's
    duration less the part of it that its child spans cover, ``launches``
    the launches counted to the spans of that name, ``counts`` the sums of
    what :func:`tally` added to them. The self times of a call
    whose spans run on one thread add up to its root's duration; where
    children run at once on several threads (the serving mesh's
    replicas), each thread's spans are counted whole, so they add up to
    more, by the time the threads overlap."""
    closed = [s for s in records() if s.end_ns is not None]
    children = {}
    for s in closed:
        if s.parent >= 0:
            children.setdefault(s.parent, []).append(s)
    out = {}
    for s in closed:
        row = out.setdefault(s.name, {"calls": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "launches": 0,
                                      "counts": {}})
        ns = s.end_ns - s.start_ns
        row["calls"] += 1
        row["total_ms"] += ns / 1e6
        row["self_ms"] += (ns - _covered(s, children.get(s.index, ()))) / 1e6
        row["launches"] += s.launches
        for k, v in (s.counts or {}).items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Traces the block into ``log_dir`` (nothing when it is empty): the
    profiler's trace, then ``spans.json``, {"spans": :func:`summary`,
    "dropped": :func:`dropped`} of the spans recorded in the block."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": summary(), "dropped": dropped()}, f, indent=1)
