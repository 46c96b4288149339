"""Leveled logging (reference: libs/util/logging.h:20-55).

Same four levels and stream routing as the reference: errors/warnings to
stderr, info/verbose/debug to stdout, with a settable verbosity cutoff.
"""

from __future__ import annotations

import enum
import sys


class LogLevel(enum.IntEnum):
    ERROR = 0
    WARNING = 1
    INFO = 2
    VERBOSE = 3
    DEBUG = 4


class Logger:
    def __init__(self, level: LogLevel = LogLevel.INFO):
        self.level = level

    def _log(self, level: LogLevel, *parts) -> None:
        if level > self.level:
            return
        stream = sys.stderr if level <= LogLevel.WARNING else sys.stdout
        print(*parts, file=stream, flush=True)

    def error(self, *parts) -> None:
        self._log(LogLevel.ERROR, *parts)

    def warning(self, *parts) -> None:
        self._log(LogLevel.WARNING, *parts)

    def info(self, *parts) -> None:
        self._log(LogLevel.INFO, *parts)

    def verbose(self, *parts) -> None:
        self._log(LogLevel.VERBOSE, *parts)

    def debug(self, *parts) -> None:
        self._log(LogLevel.DEBUG, *parts)


log = Logger()
