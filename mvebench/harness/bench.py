"""One run of one cell: set-up, the measured window, the check, the result.

Everything particular to a cell is found by name: the workload file
(mvebench/workloads/<cell>.json) names its configuration
(mvebench/configs/<config>.json), its driver (mvebench/drivers/<app>.py)
and the limits of its check; BENCHMARK.json names its metrics, and each
per-layer metric has a reader (mvebench/metrics/<metric>.py).

The loop is closed: one caller issues the next app call when the last
one returns. A call that starts inside the window completes and counts;
a rate is all the work of the completed calls over all of their time.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # mvebench/
ROOT = HERE.parent                                 # the checkout

#: Top-level module names that no run may hold once its window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mve_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"{what} {name!r} is not in BENCHMARK.json")


def load_module(kind: str, name: str):
    """mvebench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mvebench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise SystemExit(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Call:
    spec: object        # what the driver was asked to do
    seconds: float      # host clock, from the call to the device's end
    work: int           # views, samples: the unit of the cell's rate
    counters: dict      # the program's counters after the call


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader gets."""
    calls: list
    trace: object                   # harness.trace.Trace of the window, or None
    window_peak_bytes: int          # 0 off the card
    extra: dict                     # what the driver hands on (fssrecon: samples, corners)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, workload: dict, config: dict, manifest: dict, seed: int,
             seconds: float, trace: bool, device: str, workdir: str, t_start: float) -> dict:
    """One run: returns the result object (the last line's fields). The
    device check of a chip run is the caller's."""
    import torch

    dev = torch.device(device)
    driver_mod = load_module("drivers", workload["driver"])
    driver = driver_mod.Driver(workload=workload, config=config, seed=seed, device=dev,
                               workdir=workdir, trace=trace)
    driver.setup()                    # inputs made and written, one warm call
    _sync(torch, dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    calls = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    for spec in driver.specs():
        if time.perf_counter() - w0 >= seconds:
            break
        c0 = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            work, counters = driver.call(spec)
            _sync(torch, dev)
        calls.append(Call(spec, time.perf_counter() - c0, work, counters))
    window_s = time.perf_counter() - w0
    reduced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from .trace import reduce_profile

        reduced = reduce_profile(prof, window_s)
        del prof
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    leaked = forbidden_modules()

    run = Run(calls=calls, trace=reduced, window_peak_bytes=window_peak, extra=driver.extra)
    driver.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, attempted, failed, details = driver.judge(calls)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    metrics = {}
    if not trace:
        rate_name = workload["rate_metric"]
        for m in manifest["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == rate_name:
                total = sum(c.seconds for c in calls)
                metrics[rate_name] = {"value": sum(c.work for c in calls) / total if total else 0.0,
                                      "unit": m["unit"]}
    else:
        for m in manifest["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            if "workloads" not in m and m["moves"] != workload["rate_metric"]:
                continue
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    peak = max(setup_peak, window_peak)
    if dev.type == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                            "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if reduced is not None:
        result["device"]["busy_s"] = reduced.busy_s
        result["device"]["window_s"] = reduced.window_s
        result["breakdown"] = {"device_ops": reduced.device_ops(),
                               "idle_gaps": reduced.idle_gaps(label_spans=driver.label_spans)}
    result["checks"] = checks
    result["_leaked_modules"] = leaked
    result["_calls"] = [(str(c.spec), c.seconds, c.work, c.counters) for c in calls]
    result["_details"] = details
    return result


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description="Run one cell of the mve_tpu_torch benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Build and kernel caches of the program live inside the checkout, at
    # fixed paths, so that only a checkout's first run builds.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")

    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = find_entry(manifest["workloads"], args.workload, "workload")
    workload = load_json(HERE / "workloads" / f"{cell['name']}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell['chips']} CUDA device(s); {n} found", file=sys.stderr)
        return 2
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mvebench-") as workdir:
        result = run_cell(cell, workload, config, manifest, args.seed, args.seconds,
                          bool(args.trace), "cuda", workdir, t_start)
    leaked = result.pop("_leaked_modules")
    calls = result.pop("_calls")
    details = result.pop("_details")
    if leaked:
        print(f"modules of JAX or of the JAX package were loaded: {leaked}", file=sys.stderr)
        return 3
    for c in calls:
        print(f"call {c}", file=sys.stderr)
    print(f"checked: {details}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
