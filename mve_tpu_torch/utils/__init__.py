"""Host-side utility services (reference: libs/util/): INI metadata,
leveled logging, wall/CPU timers."""

from .ini import parse_ini, save_ini
from .timer import WallTimer, ClockTimer
from .logging import Logger, LogLevel

__all__ = ["parse_ini", "save_ini", "WallTimer", "ClockTimer", "Logger", "LogLevel"]
