"""The port's spans and counters: where a measurement spends its host time,
and how much work and how many cache misses each stage has.

Spans mark the stages of a measurement in a profiler's trace.
``span(name)`` enters ``torch.profiler.record_function("yawt/<name>")``
while a torch profiler records (the command line's ``--profile``, a
benchmark's traced run, any ``torch.profiler.profile`` region), and returns
a shared null context otherwise, at the cost of one check; nothing else
switches them on. The spans then lie in the profiler's own trace, on the
clock of its kernel and copy records, as ``user_annotation`` ranges. They
nest by containment on the calling thread: a span's parent is the span that
caused it, and the spans of one measurement call share its root span.

Counters count always: :data:`counters` is one process-wide dict, and
:func:`count` adds to one of its entries. Names are dotted:
``engine.launches.<kernel variant>``, ``engine.tile_pairs``,
``engine.candidate_pairs`` (tile pairs times the product of the two tile
sizes), ``cache.hit.<kind>`` and ``cache.miss.<kind>`` of the caches a
repeated measurement reuses (``tiles``, ``pairs``, ``pair_index``,
``table``, ``lanes``, ``store``), and the blocked path's
``blocked.block_pairs``, ``blocked.upload_bytes`` and ``blocked.upload_s``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import TYPE_CHECKING

import torch
from torch._C._autograd import _profiler_enabled

if TYPE_CHECKING:
    from collections.abc import Callable

__all__ = [
    "PREFIX",
    "count",
    "counters",
    "recorded",
    "reset",
    "snapshot",
    "span",
    "span_totals",
    "spanned",
]

PREFIX = "yawt/"
"""The prefix of every span name in a trace."""

counters: dict[str, int | float] = {}
"""The process-wide counters, by name."""

_NULL = contextlib.nullcontext()
_lock = threading.Lock()  # counts come from worker threads too
_off = True  # the last span found no profiler recording
_recording_from: dict[str, int | float] = {}  # counters when it began


def span(name: str):
    """A context manager that marks ``name`` as a span (``yawt/<name>``) in
    the trace of the torch profiler that records, or does nothing when
    none records."""
    global _off, _recording_from
    if not _profiler_enabled():
        _off = True
        return _NULL
    if _off:
        _off = False
        _recording_from = snapshot()
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function is the span ``name``."""

    def decorate(function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            with span(name):
                return function(*args, **kwargs)

        return wrapper

    return decorate


def count(name: str, n: int | float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        counters[name] = counters.get(name, 0) + n


def snapshot() -> dict[str, int | float]:
    """A copy of the counters."""
    with _lock:
        return dict(counters)


def reset() -> None:
    """Set every counter to zero."""
    with _lock:
        counters.clear()
        _recording_from.clear()


def recorded() -> dict[str, int | float]:
    """What the counters counted while the profiler that records now, or
    recorded last, was recording: from the first span it saw, without the
    counters that did not move. Counts of work done after it stopped are
    included up to the next recording's first span."""
    now = snapshot()
    return {
        name: value - _recording_from.get(name, 0)
        for name, value in now.items()
        if value != _recording_from.get(name, 0)
    }


def span_totals(profiler) -> dict[str, tuple[int, float]]:
    """``{name: (count, seconds)}`` of the spans in a finished
    ``torch.profiler.profile`` recording, names without :data:`PREFIX`;
    the seconds are each span's whole duration, its nested spans
    included."""
    return {
        event.key[len(PREFIX):]: (event.count, event.cpu_time_total * 1e-6)
        for event in profiler.key_averages()
        if event.key.startswith(PREFIX)
    }
