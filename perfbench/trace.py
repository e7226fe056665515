"""Reductions of a ``torch.profiler`` session to what the metric readers
read: device activity, kernels by name, device time under a profiler
range, idle gaps and the breakdown the result line carries."""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Trace", "reduce_events"]


@dataclass
class Trace:
    """One traced window.  Times in seconds; ``device`` holds every device
    activity as ``(name, start_s, duration_s)`` (kernels, copies, sets);
    ``host`` the host-side profiler events, for :meth:`range_s`, and
    ``annotations`` the names of the user ranges among them."""

    window_s: float
    items: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    annotations: set = field(default_factory=set)
    gaps: list = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device activity ran (overlaps counted
        once)."""
        total, end = 0.0, None
        for _, start, dur in sorted(self.device, key=lambda a: a[1]):
            stop = start + dur
            if end is None or start >= end:
                total += dur
                end = stop
            elif stop > end:
                total += stop - end
                end = stop
        return total

    def kernels(self, fragment: str) -> list[float]:
        """Durations of the device activities whose name holds
        ``fragment``."""
        return [dur for name, _, dur in self.device if fragment in name]

    def range_s(self, name: str) -> tuple[float, int]:
        """(device seconds of the kernels launched under the profiler
        ranges called ``name`` and their descendants, how many ranges)."""
        hits = [e for e in self.host if e.name == name]
        return sum(_device_us(e, self.annotations) for e in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, _, dur in self.device:
            key = name[:120]
            by[key] = by.get(key, 0.0) + dur
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def _device_us(event, skip: set) -> float:
    """Device microseconds of the kernels launched under a host event and
    its descendants on its thread (not the device rows' copies of user
    ranges, named in ``skip``)."""
    own = sum(k.duration for k in event.kernels if k.name not in skip)
    return own + sum(_device_us(c, skip) for c in event.cpu_children)


def reduce_events(events, window_s: float, items: int) -> Trace:
    """Reduce ``profile.events()``: device activities (without the device
    rows' copies of the user ranges), the host events, and the ten longest
    device idle gaps labelled by the innermost host event running then."""
    host = [e for e in events if e.device_type.name == "CPU"]
    ranges = {e.name for e in host if e.is_user_annotation}
    dev = [(e.name, e.time_range.start / 1e6, e.time_range.elapsed_us() / 1e6)
           for e in events
           if e.device_type.name in ("CUDA", "PrivateUse1") and e.name not in ranges]
    return Trace(window_s=window_s, items=items, device=dev, host=host,
                 annotations=ranges, gaps=_gaps(dev, host))


def _gaps(dev: list, cpu: list, n: int = 10) -> list:
    spans = sorted((s, s + d) for _, s, d in dev)
    holes, end = [], None
    for start, stop in spans:
        if end is not None and start > end:
            holes.append((start - end, end, start))
        end = stop if end is None else max(end, stop)
    holes = sorted(holes, reverse=True)[:n]
    out = []
    for length, a, b in holes:
        mid_us = (a + b) / 2 * 1e6
        inner = [e for e in cpu
                 if e.time_range.start <= mid_us <= e.time_range.end]
        label = min(inner, key=lambda e: e.time_range.elapsed_us()).name if inner \
            else "no host event"
        out.append([label[:120], length])
    return out
