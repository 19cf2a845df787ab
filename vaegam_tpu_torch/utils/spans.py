"""Named spans around the layers of a training run, on torch.profiler's clock.

Off by default: :func:`span` and :func:`step` then return one shared no-op
context, so a span site costs one flag check (no allocation, no clock
read).  :func:`enable` switches the recorder on; from then each span keeps
a record in memory,

    Span(name, start_ns, end_ns, id, parent, step, attrs)

where ``parent`` is the id of the span that was open around it (None at
the top), ``step`` is the ``(epoch, batch index)`` of the train step it
belongs to (``(epoch, None)`` for an epoch's own spans, inherited by the
spans opened inside) and ``attrs`` a dict or None.  :func:`records` returns
them in the order they closed; :func:`dump` writes them as JSON.

The timestamps are Unix-epoch nanoseconds, as torch.profiler's (kineto's
``start_ns()``) are: ``time.perf_counter_ns()`` plus one offset to
``time.time_ns()`` taken at :func:`enable`, so a step of the wall clock
cannot tear a span, and a span can be laid over the profiler's CPU and
CUDA records as it is.  While a profiler is recording, each span also
opens a ``torch.profiler.record_function`` of its name, so the spans show
in an exported trace; without one it does not (that costs microseconds a
call).

:func:`timed` is a span whose duration the caller reads (``.seconds``)
whether or not the recorder is on: the Trainer's ``epoch_seconds`` and the
device cache's ``build_seconds["upload"]`` come from the two clock reads of
their spans.

Spans are opened and closed on one thread (the one that drives training).
Work that another thread runs for a span, such as autograd's device thread
launching the backward's kernels, is found by time, not by thread.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    step: Optional[tuple]
    attrs: Optional[dict]


_on = False
_offset_ns = 0
_records: list = []
_open: list = []        # the recording spans now open, innermost last
_next_id = 0
_widths_seen: set = set()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NO_SPAN = _NoSpan()


class _Span:
    """One span; it records itself if the recorder was on when it was made."""

    __slots__ = ("name", "step", "attrs", "recording", "id", "parent", "start", "end",
                 "_rf")

    def __init__(self, name, step=None, attrs=None):
        self.name, self.step, self.attrs = name, step, attrs
        self.recording = _on
        self._rf = None

    def __enter__(self):
        global _next_id
        if self.recording:
            self.id = _next_id
            _next_id += 1
            outer = _open[-1] if _open else None
            self.parent = None if outer is None else outer.id
            if self.step is None and outer is not None:
                self.step = outer.step
            _open.append(self)
            if torch.autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.recording:
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
            if _open and _open[-1] is self:
                _open.pop()
            _records.append(Span(self.name, self.start + _offset_ns, self.end + _offset_ns,
                                 self.id, self.parent, self.step, self.attrs))
        return None

    @property
    def seconds(self) -> float:
        """The span's duration, from its own two clock reads."""
        return (self.end - self.start) * 1e-9


def enabled() -> bool:
    return _on


def enable() -> None:
    """Record spans from now on (records kept so far stay)."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    """Stop recording; the records stay until :func:`reset`."""
    global _on
    _on = False


def reset() -> None:
    """Forget the records and the batch widths seen (spans open now still
    close normally)."""
    _records.clear()
    _widths_seen.clear()


def span(name: str, step: Optional[tuple] = None, attrs: Optional[dict] = None):
    """A context that records a span called `name` when the recorder is on
    (its step id `step`, or the enclosing span's; `attrs`), and the shared
    no-op context when it is off."""
    return _Span(name, step, attrs) if _on else NO_SPAN


def step(epoch: int, index: int, width: int, kind: str):
    """The span of one train step (``train.step``): its step id is
    ``(epoch, index)``; it carries the batch `width`, its `kind` (``eager``,
    ``replay`` or ``capture``) and ``first_at_width``, true on the first
    step at this width since :func:`reset` (the step that runs cuDNN's
    algorithm search for it and, under ``epoch_scan``, its capture)."""
    if not _on:
        return NO_SPAN
    first = width not in _widths_seen
    _widths_seen.add(width)
    return _Span("train.step", (epoch, index),
                 {"width": width, "kind": kind, "first_at_width": first})


def timed(name: str, step: Optional[tuple] = None, attrs: Optional[dict] = None) -> _Span:
    """:func:`span`, but a live object whose ``.seconds`` the caller reads
    after it closes; it is recorded only when the recorder is on."""
    return _Span(name, step, attrs)


def annotate(**attrs) -> None:
    """Add `attrs` to the innermost recording span (nothing when off)."""
    if _on and _open:
        inner = _open[-1]
        inner.attrs = {**(inner.attrs or {}), **attrs}


def records() -> list:
    """The closed spans, as :class:`Span` tuples in the order they closed."""
    return list(_records)


def dump(path: str) -> None:
    """Write the records to `path` as JSON: one object a span."""
    with open(path, "w") as f:
        json.dump([r._asdict() for r in _records], f)
