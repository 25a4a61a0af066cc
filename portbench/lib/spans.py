"""The program's own spans in a traced window
(``melspec_tpu_torch/utils/profiling.py``): its records whose host start
lies in the window, grouped by the call they belong to. The program stamps
them on ``time.time_ns()``, the clock of ``torch.profiler``'s events, so
they are placed against ``TraceView.window`` with no conversion.

A record's ``device_ms`` is the device time between its two timing
events: None on the CPU, where a span has no device events, so a reader of
device times finds nothing to read there."""

from __future__ import annotations


def calls(view) -> dict:
    """``{call id: [records]}`` of the program's records whose host start
    lies in ``view.window``; empty where the program keeps no records."""
    try:
        from melspec_tpu_torch.utils import profiling
    except ImportError:
        return {}
    records = getattr(profiling, "records", None)
    if records is None:
        return {}
    lo, hi = view.window
    out = {}
    for r in records():
        if lo <= r.start_ns < hi:
            out.setdefault(r.call, []).append(r)
    return out


def stage_ms(view, names) -> float | None:
    """Mean device ms a call in the spans ``names`` (summed within a call),
    over the window's calls that hold one of them with a device time; None
    where no call does."""
    per_call = []
    for recs in calls(view).values():
        ms = [r.device_ms for r in recs if r.name in names]
        if ms and all(m is not None for m in ms):
            per_call.append(sum(ms))
    return sum(per_call) / len(per_call) if per_call else None
