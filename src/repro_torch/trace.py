"""The program's own spans and counters, on the profiler's clock.

Built like the kernels' work observer (``kernels.ops.set_work_observer``):
one module global, unset by default. Unset, ``span(name)`` returns one
shared ``contextlib.nullcontext()`` and ``count(name)`` returns after one
check, so the serve path pays a call and allocates nothing.

Under ``enabled(tracer)`` each span enters a profiler range named
``repro_torch.<name>``, as ``torch.profiler.record_function`` makes (a
profile then shows the program's phases beside the device ops), and keeps
its start and end on ``time.perf_counter``, the index of its parent span
and what was counted inside it: ``count`` adds to the innermost open span.
Python's collections run as ``gc.collect`` spans whose ``gc.generation``
counter is the generation collected. The tracer keeps everything in
memory; nothing is written anywhere.

Counters named ``sync.*`` count host waits on the device, one per wait,
at the line that causes it.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional

import torch

PREFIX = "repro_torch."

_TRACER: Optional["Tracer"] = None
_OFF = contextlib.nullcontext()
# a profiler range without ``record_function``'s Python object and op
# calls (about a tenth of its cost)
_RANGE = torch._C._profiler._RecordFunctionFast


class Span:
    """One span, and its context while it is open: ``parent`` is the index
    of the span it ran in, -1 at the top; ``counters`` is None until
    something is counted in it."""
    __slots__ = ("name", "start", "end", "parent", "counters", "_tracer",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str):
        self.name = name
        self.start = self.end = float("nan")
        self.parent = -1
        self.counters: Optional[Dict[str, int]] = None
        self._tracer: Optional[Tracer] = tracer

    def __enter__(self):
        self._range = _RANGE(PREFIX + self.name)
        self._range.__enter__()
        tracer = self._tracer
        if tracer._open:
            self.parent = tracer._open[-1]
        # a collection while this span or its range was made has recorded
        # its own span already: the index is taken after it
        tracer._open.append(len(tracer.spans))
        tracer.spans.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self._tracer._open.pop()              # spans close innermost first
        self._tracer = None
        self._range.__exit__(*exc)
        self._range = None
        return False


class Tracer:
    """Every span in the order it opened, and the counts made outside any
    span."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open: List[int] = []        # indices of open spans, innermost last
        self._gc: List[Span] = []

    def add(self, name: str, n: int = 1) -> None:
        if self._open:
            span = self.spans[self._open[-1]]
            if span.counters is None:
                span.counters = {}
            counters = span.counters
        else:
            counters = self.counters
        counters[name] = counters.get(name, 0) + n


def span(name: str):
    """A context manager around one phase of the program."""
    tracer = _TRACER
    if tracer is None:
        return _OFF
    return Span(tracer, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    tracer = _TRACER
    if tracer is None:
        return
    tracer.add(name, n)


def _on_gc(phase: str, info: dict) -> None:
    tracer = _TRACER
    if tracer is None:
        return
    if phase == "start":
        tracer._gc.append(Span(tracer, "gc.collect").__enter__())
        tracer.add("gc.generation", info["generation"])
    elif tracer._gc:
        tracer._gc.pop().__exit__(None, None, None)


@contextlib.contextmanager
def enabled(tracer: Optional[Tracer]):
    """Set ``tracer`` (None: none) while the block runs; the one it
    replaced is set again on the way out, whatever the block raised."""
    global _TRACER
    previous, _TRACER = _TRACER, tracer
    if tracer is not None and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    try:
        yield tracer
    finally:
        _TRACER = previous
        if previous is None and _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)
