"""The device part of FSSR's block evaluation (fssr/block_eval.run_chunk:
the host's tables and queued launches, then the wait and the one read
back), from block_eval.STATS["dispatch_ms"] + STATS["sync_ms"], over the
input samples of the window's calls."""

UNIT = "us/sample"
LAYER = "FSSR block evaluation"
MOVES = "fssrecon_samples_per_s"


def read(run):
    samples = sum(c.counters["samples"] for c in run.calls)
    ms = sum(c.counters["dispatch_ms"] + c.counters["sync_ms"] for c in run.calls)
    return 1e3 * ms / samples if samples else None
