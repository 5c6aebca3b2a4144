"""The traced run: torch.profiler over the window, reduced to intervals.

Device activity is every event the profiler puts on the card (kernels,
copies, fills) but the annotations that mirror host spans there.  Host
events are the CPU-side events: PyTorch ops, the CUDA runtime calls and
the benchmark's own spans (`record_function`): "gpubench.call" around
each engine call, and one around each program function a driver names
(`spans`).  All times are microseconds on the profiler's one timeline.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib
import re
from dataclasses import dataclass, field

CALL_SPAN = "gpubench.call"


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (name, start, end)

    def calls(self):
        return sorted((s, e) for name, s, e in self.host if name == CALL_SPAN)


def from_profiler(prof) -> Trace:
    """The intervals of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType
    tr = Trace()
    for ev in prof.events():
        rng = ev.time_range
        item = (ev.name, float(rng.start), float(rng.end))
        if ev.device_type == DeviceType.CPU:
            tr.host.append(item)
        elif not getattr(ev, "is_user_annotation", False) \
                and not ev.name.startswith("gpubench."):
            tr.device.append(item)
    return tr


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(union, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the disjoint union covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union)


def gaps(union, lo: float, hi: float):
    """The idle intervals of [lo, hi] outside the union."""
    out, at = [], lo
    for s, e in union:
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def host_doing(host, times):
    """For each time (ascending), the innermost host event open then (the
    narrowest span: a program function's span or a PyTorch op before the
    engine call's span), or "harness" outside every call."""
    events = sorted(host, key=lambda h: h[1])
    heap, out, k = [], [], 0
    for t in times:
        while k < len(events) and events[k][1] <= t:
            name, s, e = events[k]
            heapq.heappush(heap, (e - s, e, name))
            k += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "harness")
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list (other
    device operations, such as "Memcpy DtoH (Device -> Pageable)", as
    they are)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and k and name[k - 1] != " ":
            return name[:k][:120]
    return name[:120]


def breakdown(trace: Trace, lo: float, hi: float, top: int = 10):
    """device_ops: seconds on the card by operation; idle_gaps: seconds of
    the window the card sat idle, by what the host was doing then (the
    innermost host event at the middle of each gap)."""
    ops: dict[str, float] = {}
    for name, s, e in trace.device:
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + max(0.0, min(e, hi) - max(s, lo))
    idle: dict[str, float] = {}
    union = merge((s, e) for _n, s, e in trace.device)
    idle_at = gaps(union, lo, hi)
    names = host_doing(trace.host, [(s + e) / 2 for s, e in idle_at])
    for (s, e), key in zip(idle_at, names):
        idle[key] = idle.get(key, 0.0) + (e - s)

    def top_of(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}


def kernel_seconds(trace: Trace, names, lo: float, hi: float) -> float:
    """Device seconds of the kernels whose names hold one of `names` as a
    whole word."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for n, s, e in trace.device if pat.search(n)) / 1e6


def record(on: bool):
    """The span around one engine call, in a traced run."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(CALL_SPAN)


@contextlib.contextmanager
def spans(targets):
    """Wrap each (module, function) in a record_function span of its name
    for the duration; callers that look the name up in the module at
    call time see the wrapper."""
    import torch
    undo = []
    try:
        for mod_name, attr in targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _name=f"gpubench.{attr}", **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            setattr(mod, attr, wrapped)
            undo.append((mod, attr, fn))
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)
