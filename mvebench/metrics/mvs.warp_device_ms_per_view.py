"""The device time of the warp solver's phases a view: the CUDA-event
times of the program's mvs.solve.warp_* span records (sweep, propagate,
refine, plane, accept), over the views the mvs.solve records count as
views_warp."""

from mvebench.harness import spans

UNIT = "ms/view"
LAYER = "MVS warp solver"
MOVES = "dmrecon_views_per_s"


def read(run):
    records = spans.call_records(run) or []
    views = sum(r.counters.get("views_warp", 0) for r in records if r.name == "mvs.solve")
    phases = [r.device_ms for r in records
              if r.name.startswith("mvs.solve.warp_") and r.device_ms is not None]
    return sum(phases) / views if views and phases else None
