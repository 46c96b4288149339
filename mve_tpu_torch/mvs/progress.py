"""MVS reconstruction progress (reference: libs/dmrecon/progress.h).

The reference exposes a ``Progress`` struct with a ``RECON_*`` status enum
and counters that the CLI's fancy printer and the GUI poll from another
thread; setting ``cancelled`` makes the reconstruction stop at the next
stage boundary. This mirrors that contract for pollers of ``DMRecon``.
"""

from __future__ import annotations

import dataclasses
import enum
import time


class ReconStatus(enum.Enum):
    """progress.h:19-24 ReconStatus."""

    IDLE = "idle"
    GLOBALVS = "global view selection"
    FEATURES = "feature seeds"
    QUEUE = "optimizing"
    SAVING = "saving"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Progress:
    """Polled reconstruction state (progress.h Progress struct)."""

    status: ReconStatus = ReconStatus.IDLE
    filled: int = 0          # accepted pixels so far
    queue_size: int = 0      # optimization rounds remaining
    start_time: float = 0.0
    cancelled: bool = False

    def begin(self) -> None:
        # ``cancelled`` is NOT reset: pollers may request cancellation at
        # any time, including before the run starts (progress.h ctor only).
        self.status = ReconStatus.IDLE
        self.filled = 0
        self.queue_size = 0
        self.start_time = time.time()

    def check_cancelled(self) -> None:
        """Raise at stage boundaries when a poller requested cancellation
        (the reference checks progress.cancelled inside its loops)."""
        if self.cancelled:
            self.status = ReconStatus.CANCELLED
            raise RuntimeError("reconstruction cancelled")

    def elapsed(self) -> float:
        return time.time() - self.start_time if self.start_time else 0.0
