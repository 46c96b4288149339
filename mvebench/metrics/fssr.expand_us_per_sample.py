"""The time of the host's block plan of the evaluation (fssr/block_eval.run_chunk's block expansion and sort), from block_eval.STATS["expand_ms"], over the input samples of the window's calls."""

UNIT = "us/sample"
LAYER = "FSSR block plan"
MOVES = "fssrecon_samples_per_s"


def read(run):
    samples = sum(c.counters["samples"] for c in run.calls)
    return 1e3 * sum(c.counters["expand_ms"] for c in run.calls) / samples if samples else None
