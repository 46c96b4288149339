"""Timers (reference: libs/util/timer.h).

WallTimer measures wall-clock milliseconds, ClockTimer CPU time —
the same split the reference uses for its per-stage progress reports.
"""

from __future__ import annotations

import time


class WallTimer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def get_elapsed(self) -> int:
        """Elapsed wall time in milliseconds."""
        return int((time.perf_counter() - self._start) * 1000.0)

    def get_elapsed_sec(self) -> float:
        return time.perf_counter() - self._start


class ClockTimer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.process_time()

    def get_elapsed(self) -> int:
        """Elapsed CPU time in milliseconds."""
        return int((time.process_time() - self._start) * 1000.0)

    def get_elapsed_sec(self) -> float:
        return time.process_time() - self._start


class FrameTimer:
    """Frame pacing (reference: libs/util/frame_timer.h) — measures frame
    intervals and sleeps to hold a target rate."""

    def __init__(self, target_fps: float = 30.0):
        self.target_fps = target_fps
        self._last = time.perf_counter()
        self.frame_count = 0

    def next_frame(self) -> float:
        """Sleep until the next frame slot; returns the actual interval."""
        now = time.perf_counter()
        elapsed = now - self._last
        budget = 1.0 / self.target_fps
        if elapsed < budget:
            time.sleep(budget - elapsed)
            now = time.perf_counter()
            elapsed = now - self._last
        self._last = now
        self.frame_count += 1
        return elapsed
