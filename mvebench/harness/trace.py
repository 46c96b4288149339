"""What the benchmark reads from a torch.profiler trace of the window.

The window's calls run under one profiler (host and CUDA activities);
this module reduces its raw events once: the device's kernel intervals
(busy time as their union), the host spans by name (the program's
`record_function` marks, such as fssr.block_eval, and the benchmark's
own around each call), the device operations that took the most time
and the idle gaps on the device labelled by what the host was doing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: list          # (start_ns, end_ns, name), sorted by start
    spans: dict            # name -> [(start_ns, end_ns)], host record_function ranges
    host_ops: list         # (start_ns, end_ns, name) of host torch ops, sorted by start

    @property
    def busy_s(self) -> float:
        return union_ns([(a, b) for a, b, _ in self.kernels]) / 1e9

    def kernel_s_inside(self, span: str) -> float:
        """Seconds of the kernels that run within a host span of that name
        (the span ends after the program has waited for its kernels)."""
        ranges = sorted(self.spans.get(span, []))
        total, j = 0, 0
        for a, b, _ in self.kernels:
            while j < len(ranges) and ranges[j][1] < a:
                j += 1
            if j < len(ranges) and ranges[j][0] <= a and b <= ranges[j][1]:
                total += b - a
        return total / 1e9

    def device_ops(self, top: int = 10) -> list:
        by_name: dict = {}
        for a, b, name in self.kernels:
            by_name[name] = by_name.get(name, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], ns / 1e9] for name, ns in ops]

    def idle_gaps(self, top: int = 10, label_spans=()) -> list:
        """The device's idle time between kernels, summed by what the host
        was doing at each gap's midpoint: the innermost of the given host
        spans that covers it, then the innermost torch op, or "host code
        outside torch ops" where none does."""
        gaps, end = [], None
        for a, b, _ in self.kernels:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        mids = [(a + b) // 2 for a, b in gaps]
        ops = _innermost_at(self.host_ops, mids)
        named = sorted((s, e, n) for n in label_spans for s, e in self.spans.get(n, []))
        outer = _innermost_at(named, mids)
        by_label: dict = {}
        for (a, b), op, span in zip(gaps, ops, outer):
            label = op or "host code outside torch ops"
            if span:
                label = f"{span}: {label}"
            by_label[label] = by_label.get(label, 0) + (b - a)
        out = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], ns / 1e9] for name, ns in out]


def _innermost_at(intervals, times) -> list:
    """For each of the ascending times, the name of the interval that
    covers it and starts last (the innermost of nested ones), or None:
    one sweep over the intervals, sorted by start, with a stack of those
    still open."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(intervals) and intervals[i][0] <= t:
            s, e, name = intervals[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        # An interval below the top may still cover t where intervals
        # overlap without nesting (other threads); the top is the latest.
        out.append(stack[-1][1] if stack else None)
    return out


def union_ns(intervals) -> int:
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def reduce_profile(prof, window_s: float) -> Trace:
    """A Trace from a finished torch.profiler.profile. Reads the raw
    events (one pass, no per-event Python objects from key_averages)."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    # A record_function range is mirrored on the device's timeline under
    # its own name; it is no operation on the device.
    marks = {e.name() for e in events if e.is_user_annotation()}
    kernels, spans, host_ops = [], {}, []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in marks:
                kernels.append((a, b, e.name()))
        elif e.is_user_annotation():
            spans.setdefault(e.name(), []).append((a, b))
        elif e.name().startswith("aten::") or e.name().startswith("cuda"):
            host_ops.append((a, b, e.name()))
    kernels.sort()
    host_ops.sort()
    return Trace(window_s=window_s, kernels=kernels, spans=spans, host_ops=host_ops)
