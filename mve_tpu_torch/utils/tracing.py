"""Profiling/tracing hooks (port of mve_tpu/utils/tracing.py; the
reference prints WallTimer spans).

`span(name)` marks its block with torch.profiler.record_function, so the
span shows by name in any profile taken around it. While a torch
profiler session is active, or MVE_TPU_TRACE_DIR is set, it also keeps a
`SpanRecord` in memory: its name, its start and end on `time.time_ns()`
(the clock the profiler stamps its host events with), its id, its
parent's id, the id of the outermost span it lies in (the call) and its
counters, which `count` adds to. `records()` returns them and `clear()`
empties the list. With `device` naming a CUDA device, a recorded span
also records a CUDA event at entry and exit; their elapsed time is read
by `read_device_times()`, which the program calls after a sync of its
own, so a span never waits for the device. With recording off a span is
one record_function and one check: no event, no tensor, no record.

With MVE_TPU_TRACE_DIR set, the outermost span profiles its block (host
and, where CUDA is present, device activity) and writes one Chrome trace
under <MVE_TPU_TRACE_DIR>/<name>/ that holds every span inside it. It
starts no profiler where one is already running. `trace_stage` is a span
that also reports its wall time through the callback, or prints it when
MVE_TPU_TRACE_VERBOSE is set. The variables keep mve_tpu's names, so one
environment drives both packages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class SpanRecord:
    name: str
    id: int
    parent: Optional[int]      # the enclosing recorded span's id
    call: int                  # the outermost recorded span's id
    start_ns: int              # time.time_ns()
    end_ns: Optional[int] = None
    counters: dict = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None   # CUDA events' elapsed time, once read


_RECORDS: list = []
_PENDING: list = []            # (record, start event, end event) not read yet
_IDS = itertools.count(1)
_OPEN = threading.local()      # .stack: this thread's open recorded spans


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _start_profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


@contextlib.contextmanager
def span(name: str, device=None):
    """Mark a block as a span named `name` (see the module docstring).

    device: None, or the device whose work the span also times with CUDA
    events on its current stream; a CPU device times nothing."""
    trace_dir = os.environ.get("MVE_TPU_TRACE_DIR")
    prof = None
    if trace_dir and not torch.autograd._profiler_enabled():
        prof = _start_profile()
    try:
        with torch.profiler.record_function(name):
            if not (trace_dir or torch.autograd._profiler_enabled()):
                yield
                return
            stack = _stack()
            parent = stack[-1] if stack else None
            rid = next(_IDS)
            rec = SpanRecord(name, rid, parent.id if parent else None,
                             parent.call if parent else rid, time.time_ns())
            _RECORDS.append(rec)
            stack.append(rec)
            events = None
            if device is not None and torch.device(device).type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                stream = torch.cuda.current_stream(device)
                events[0].record(stream)
            try:
                yield
            finally:
                if events is not None:
                    events[1].record(stream)
                    _PENDING.append((rec, *events))
                stack.pop()
                rec.end_ns = time.time_ns()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        out = os.path.join(trace_dir, name)
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(out, f"{time.time_ns()}-{os.getpid()}.pt.trace.json"))


def count(key: str, n=1) -> None:
    """Add n to counter `key` of the innermost open recorded span (nothing
    when no span records)."""
    stack = getattr(_OPEN, "stack", None)
    if stack:
        counters = stack[-1].counters
        counters[key] = counters.get(key, 0) + n


def read_device_times() -> None:
    """Read the elapsed time of the CUDA events of the spans closed so far
    into their records. Call only after a sync that covers those spans'
    work: it waits for nothing."""
    for rec, start, end in _PENDING:
        rec.device_ms = start.elapsed_time(end)
    _PENDING.clear()


def records() -> list:
    """The spans recorded so far, in the order they opened."""
    return _RECORDS


def clear() -> None:
    _RECORDS.clear()
    _PENDING.clear()


@contextlib.contextmanager
def trace_stage(name: str, report: Optional[Callable[[str, float], None]] = None):
    """Time a pipeline stage as a span; optionally write a profile of it."""
    t0 = time.perf_counter()
    with span(name):
        yield
        elapsed = time.perf_counter() - t0
    if report is not None:
        report(name, elapsed)
    elif os.environ.get("MVE_TPU_TRACE_VERBOSE"):
        print(f"[trace] {name}: {elapsed * 1000:.1f}ms")
