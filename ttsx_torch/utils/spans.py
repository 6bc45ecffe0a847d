"""Spans and counters of the port, on the host's clock and, under
``torch.profiler``, on the profiler's.

    with span("serve.pad"):
        ...
    count("serve.frames_run", 8 * 864)

A span records its name, its attributes, its start and end
(``time.perf_counter_ns``), the span open around it on the same thread
(``parent``, an index into the recorder's ``spans``) and ``id``: the
call or engine step it belongs to, given by the outermost span of a
call (``serve.call``, ``train.step``) and inherited by every span
opened inside it. ``count`` adds to a named counter of the same
recorder.

Nothing is recorded unless a recorder is on: inside ``recording()``,
which opens a fresh recorder (for an operator or a test), or while a
``torch.profiler`` session is active, when the process's default
recorder (``recorded()``, emptied by ``clear()``) takes the spans and
counters. The default recorder holds one session: the first span or
count of a session empties what an earlier one left, so it keeps the
last session until the next begins. (A session is told from the one
before it by a span or count run with no profiler on in between; two
profiler cycles with no such call between them share a record.) Off,
``span`` and ``count`` cost a flag check and return.
While a profiler is active, every span also enters
``torch.profiler.record_function(name)``, so it appears in the trace as
a ``user_annotation`` on the profiler's clock, and the trace's idle
gaps and device ranges can be read by the program's span names.

``timed(name)`` is a span that times itself whether or not a recorder
is on: its ``seconds`` is what the engine reports as ``step_time_s``
(``train.step``) and the collator as ``collate_time`` (``collate``).

The span names of the port, by layer: ``serve.call`` (``serve.pad``,
``serve.upload``, ``serve.run``, ``serve.fetch``, ``serve.trim``);
``synth.acoustic``, ``synth.refiner``, ``synth.gst``,
``synth.generator``; ``train.step`` (``train.place``,
``train.next_batch``, ``train.acoustic``, ``train.refiner``,
``train.gan``, ``train.metrics``); ``gan.disc_step`` (attribute
``r1``), ``gan.gen_step``; ``optim.update`` (attribute ``module``);
``nn.spectral_normalize``; ``collate``. Counters:
``serve.frames_requested``, ``serve.frames_run``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler


class Span:
    """One span; ``seconds`` once it has closed."""

    __slots__ = ("name", "attrs", "id", "parent", "index", "start_ns",
                 "end_ns", "_rec", "_rf")

    def __init__(self, name: str, id: Optional[int], attrs: Dict,
                 rec: Optional["Recorder"]):
        self.name, self.id, self.attrs = name, id, attrs
        self.parent: Optional[int] = None
        self.index = -1
        self.start_ns = self.end_ns = 0
        self._rec, self._rf = rec, None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        rec = self._rec
        if rec is not None:
            stack = _stack()
            if stack:
                outer = stack[-1]
                if self.id is None:
                    self.id = outer.id
                if outer._rec is rec:
                    self.parent = outer.index
            self.index = rec._add(self)
            stack.append(self)
            if _profiler._is_profiler_enabled:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        # the span's clock readings lie inside the profiler's range, so
        # the range's own cost stays out of the span's time
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._rec is not None:
            _stack().pop()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.seconds * 1e3:.3f} ms)")


class Recorder:
    """The spans (in the order they opened) and counters of one recording."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def _add(self, s: Span) -> int:
        with self._lock:
            self.spans.append(s)
            return len(self.spans) - 1

    def add(self, name: str, n: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def named(self, name: str) -> List[Span]:
        """The closed spans called ``name``."""
        return [s for s in self.spans if s.name == name and s.end_ns]

    def seconds(self, *names: str) -> float:
        """The summed durations of the closed spans of these names."""
        return sum(s.seconds for n in names for s in self.named(n))

    def __bool__(self) -> bool:
        return bool(self.spans or self.counters)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_DEFAULT = Recorder()
_opened: List[Recorder] = []      # the recorders of open ``recording()``s
_local = threading.local()
_between = True     # no profiler on since the default recorder last took one


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _on() -> Optional[Recorder]:
    global _between
    if not _profiler._is_profiler_enabled:
        _between = True
        return _opened[-1] if _opened else None
    if _opened:
        return _opened[-1]
    if _between:                    # a new profiler session: a new record
        _between = False
        clear()
    return _DEFAULT


def span(name: str, id: Optional[int] = None, **attrs):
    """A context manager that records a span while a recorder is on."""
    rec = _on()
    if rec is None:
        return _OFF
    return Span(name, id, attrs, rec)


def timed(name: str, id: Optional[int] = None, **attrs) -> Span:
    """A span whose ``seconds`` is kept whether or not a recorder is on."""
    return Span(name, id, attrs, _on())


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while a recorder is on."""
    rec = _on()
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """A fresh recorder, on inside the block (in place of the default
    one, profiler or not); kept with what it recorded afterwards."""
    rec = Recorder()
    _opened.append(rec)
    try:
        yield rec
    finally:
        _opened.remove(rec)


def recorded() -> Recorder:
    """The process's default recorder: what was recorded in the last
    profiler session (so far) while no ``recording()`` was open."""
    return _DEFAULT


def clear() -> None:
    """Empty the default recorder."""
    with _DEFAULT._lock:
        _DEFAULT.spans.clear()
        _DEFAULT.counters.clear()
