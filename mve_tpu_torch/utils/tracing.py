"""Profiling/tracing hooks (port of mve_tpu/utils/tracing.py; the
reference prints WallTimer spans).

`trace_stage` marks its block with torch.profiler.record_function, so the
span shows by name in any profile taken around it. With MVE_TPU_TRACE_DIR
set it also profiles the block itself (host and, where CUDA is present,
device activity) and writes a Chrome trace under
<MVE_TPU_TRACE_DIR>/<name>/. Without it the stage reports its wall time
through the callback, or prints it when MVE_TPU_TRACE_VERBOSE is set. The
variables keep mve_tpu's names, so one environment drives both packages.

Only one torch.profiler session runs at a time: with MVE_TPU_TRACE_DIR
set, do not nest a trace_stage inside another profiler.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace_stage(name: str, report: Optional[Callable[[str, float], None]] = None):
    """Time a pipeline stage; optionally write a profile of it."""
    trace_dir = os.environ.get("MVE_TPU_TRACE_DIR")
    prof = None
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        with torch.profiler.record_function(name):
            yield
    elapsed = time.perf_counter() - t0
    if prof is not None:
        out = os.path.join(trace_dir, name)
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(out, f"{time.time_ns()}-{os.getpid()}.pt.trace.json"))
    if report is not None:
        report(name, elapsed)
    elif os.environ.get("MVE_TPU_TRACE_VERBOSE"):
        print(f"[trace] {name}: {elapsed * 1000:.1f}ms")
