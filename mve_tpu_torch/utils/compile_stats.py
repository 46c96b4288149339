"""Compile-vs-execute attribution counters (port of
mve_tpu/utils/compile_stats.py, host code, copied).

mve_tpu records here the time each XLA compile of its BA programs takes,
so that the bench and the apps can tell compilation from execution. The
port runs eager PyTorch, which compiles nothing: its BA records nothing,
and counts() stays {} unless a caller records a tag itself. The module
keeps mve_tpu's interface for such callers.
"""

from __future__ import annotations

import collections

_compile_ms: dict = collections.defaultdict(float)
_compile_count: dict = collections.defaultdict(int)


def record(tag: str, ms: float) -> None:
    _compile_ms[tag] += ms
    _compile_count[tag] += 1


def total_ms(tag: str | None = None) -> float:
    if tag is not None:
        return _compile_ms.get(tag, 0.0)
    return sum(_compile_ms.values())


def counts() -> dict:
    return {k: (_compile_count[k], round(v, 1)) for k, v in _compile_ms.items()}


def reset() -> None:
    _compile_ms.clear()
    _compile_count.clear()
