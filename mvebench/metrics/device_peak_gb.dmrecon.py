"""The most device memory the program held during the window
(torch.cuda.max_memory_allocated, reset when the window opens), in GB."""

UNIT = "GB"
LAYER = "device"
MOVES = "dmrecon_views_per_s"


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
