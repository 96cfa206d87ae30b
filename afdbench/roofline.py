"""A kernel's share of its roofline over a traced window: the least time
of every call the kernel front door saw (``afdbench.work``) over the
device time the profiler measured for those calls."""

from __future__ import annotations

from typing import Optional

from afdbench import work


def share(t, kind: str) -> Optional[float]:
    """``kind``'s roofline share in percent, or None where the window ran
    no such call or the device time was not measured."""
    if t.profile is None:
        return None
    calls = [c for c in t.calls if c.kind == kind]
    device_s = t.profile["op_device_s"].get(kind, 0.0)
    if not calls or device_s <= 0:
        return None
    least = sum(work.bound_s(*work.WORK[kind](c)) for c in calls)
    return work.share_pct(least, device_s, f"{kind} roofline")
