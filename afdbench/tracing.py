"""The traced run's instruments, all in the benchmark's own files.

* ``Spans`` wraps calls into a layer (the engine's ``tick``, the runtime
  instance's ``decode_step_3bo`` and ``prefill``): a
  ``torch.profiler.record_function`` range named ``afdbench.<span>``, the
  host's wall time, and a device sync at its end, so the wall covers the
  device work the call enqueued. A traced run opens them with the window
  and reads their walls from the part before the profiler starts.
* ``Observer`` is set with ``repro_torch.kernels.ops.set_work_observer``:
  each kernel op at the front door runs inside an ``afdbench.op.<kind>``
  range, and its inputs' shapes (and the group sizes or lengths its work
  depends on) are kept for the benchmark's own work arithmetic
  (``afdbench.work``).
* ``reduce_profile`` turns the ``torch.profiler`` trace into the device's
  busy time, the device ops by name, each op kind's device time (the
  kernels launched inside its ranges), and the longest idle gaps labelled
  by the span the host was in.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

from afdbench.work import Call

# the kernel names of the three hand-written kernels, used where the
# profiler links a kernel to no range (a launch it could not correlate)
KERNEL_NAMES = {"grouped_gemm": "grouped_gemm_", "splitkv": "splitkv_",
                "flash_prefill": "flash_prefill_"}
_KINDS = {"grouped_gemm_work": "grouped_gemm", "splitkv_work": "splitkv",
          "flash_prefill_work": "flash_prefill"}
SPAN_PREFIX = "afdbench."


class Spans:
    """Host wall spans with a profiler range each, sync-ended. ``walls``
    and ``args`` keep each call's start on the host clock beside its wall
    or its note."""

    def __init__(self, device: torch.device):
        self.device = device
        self.walls: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.args: Dict[str, List[Tuple[float, tuple]]] = \
            collections.defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.walls[name].append((t0, time.perf_counter() - t0))

    def wrap(self, name: str, fn, note=None):
        """``fn`` inside ``span(name)``; ``note(*args)``, if given, records
        what the call was asked to do."""
        def wrapped(*args, **kwargs):
            if note is not None:
                self.args[name].append((time.perf_counter(),
                                        note(*args, **kwargs)))
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


def _shape(t) -> Optional[Tuple[int, ...]]:
    return None if t is None else tuple(int(s) for s in t.shape)


def _size(t) -> int:
    return 0 if t is None else t.element_size()


class Observer:
    """The kernel front door's work observer (``ops.set_work_observer``)."""

    def __init__(self):
        self.calls: List[Call] = []
        self._pending: List[Tuple[Call, str, torch.Tensor]] = []

    def kernel(self, work, *inputs):
        kind = _KINDS[work.__name__]
        if kind == "grouped_gemm":
            lhs, rhs, sizes, row_index, out_index, out_rows, scales = inputs
            named = {"lhs": lhs, "rhs": rhs, "group_sizes": sizes,
                     "row_index": row_index, "out_index": out_index,
                     "scales": scales}
            call = Call(kind, {k: _shape(v) for k, v in named.items()},
                        {k: _size(v) for k, v in named.items()},
                        args={"out_rows": out_rows})
            self._pending.append((call, "group_sizes", sizes))
        elif kind == "splitkv":
            q, k, v, lengths, return_lse = inputs
            named = {"q": q, "k": k, "lengths": lengths}
            call = Call(kind, {n: _shape(t) for n, t in named.items()},
                        {n: _size(t) for n, t in named.items()},
                        args={"return_lse": bool(return_lse)})
            self._pending.append((call, "lengths", lengths))
        else:
            q, k, causal, window, q_offset, t_valid = inputs
            call = Call(kind, {"q": _shape(q), "k": _shape(k)},
                        {"q": _size(q), "k": _size(k)},
                        args={"causal": bool(causal), "window": window,
                              "q_offset": int(q_offset),
                              "t_valid": None if t_valid is None
                              else int(t_valid)})
        self.calls.append(call)
        return torch.profiler.record_function(SPAN_PREFIX + "op." + kind)

    def finish(self) -> List[Call]:
        """Read back the values the work depends on (after the window)."""
        for call, name, t in self._pending:
            call.values[name] = t.detach().cpu().tolist()
        self._pending = []
        return self.calls


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_profile(prof) -> dict:
    """The trace's numbers, times in seconds: ``busy_s`` (union of device
    ops), ``device_ops`` (count), ``ops_by_name`` [(name, s)] longest
    first, ``op_device_s`` {kind: s} (kernels linked to the kind's ranges,
    or by kernel name where they are not linked), ``op_linked`` {kind:
    the kind's own kernels linked}, ``idle_gaps`` [(span, s)] longest
    first."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev, ranges, spans = [], collections.defaultdict(list), []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):
                dev.append(e)
        elif e.name.startswith(SPAN_PREFIX + "op."):
            ranges[e.name[len(SPAN_PREFIX) + 3:]].append(e)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append(e)
    by_name: Dict[str, float] = collections.defaultdict(float)
    intervals = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        intervals.append((a, b))
        by_name[e.name] += (b - a) * 1e-6
    merged = _merge(intervals)
    busy = sum(b - a for a, b in merged) * 1e-6
    op_s, linked = {}, {}
    for kind, pat in KERNEL_NAMES.items():
        evs = ranges.get(kind, [])
        names = [n for e in evs for n in _linked_kernels(e)]
        linked[kind] = sum(1 for n in names if pat in n)
        if not evs:
            continue
        if linked[kind] >= len(evs):
            op_s[kind] = sum(e.device_time_total for e in evs) * 1e-6
        else:                       # not linked: the kernel's own name
            op_s[kind] = sum(s for n, s in by_name.items() if pat in n)
    # idle gaps, labelled by the innermost span open on the host when the
    # gap ended (the host was enqueuing the op that ended it)
    spans.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    gaps = sorted(((b2 - a1, a1, b2) for (_, a1), (b2, _)
                   in zip(merged, merged[1:])), reverse=True)[:10]
    labelled = []
    for length, _, end in gaps:
        label = "harness"
        best = None
        for e in spans[:bisect.bisect_right(starts, end)]:
            if e.time_range.end >= end and (
                    best is None or e.time_range.start >= best.time_range.start):
                best = e
        if best is not None:
            label = best.name[len(SPAN_PREFIX):]
        labelled.append((label, length * 1e-6))
    return {"busy_s": busy, "device_ops": len(dev),
            "ops_by_name": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "op_device_s": op_s, "op_linked": linked,
            "idle_gaps": labelled}


def _linked_kernels(e) -> List[str]:
    """Names of the device ops the profiler linked to ``e`` and the ops
    under it."""
    names = [k.name for k in e.kernels]
    for ch in e.cpu_children:
        names += _linked_kernels(ch)
    return names
