"""The controls of the benchmark's check, at a cell's own size.

For each seed: the cell's set-up and a few calls of its own (the load of
a run, without a timed window), then the check twice: once on what the
program produced, once with the control in the program's place. The
control has to come out as not correct; the program's numbers are the
lower readings its limits are set from, the control's the upper.

- dmrecon cells: the scene's true depth written as camera-z depth
  instead of ray length (a broken guarantee of the configuration), over
  the views the calls reconstructed.
- fssrecon cells: the reference's implicit function computed in
  bfloat16 after the float64 offsets (the precision below the
  program's float32), at the corners each call's check reads.

    python3 mvebench/controls.py --workload <cell> --seeds 11,12,13 [--calls 3]

The benchmark's own runs do not run it. Prints one JSON line per seed.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from mvebench.harness import bench  # noqa: E402


def readings(cell_name: str, seed: int, n_calls: int, device: str = "cuda",
             workload=None, config=None, cell=None) -> dict:
    """{"program": checks, "control": checks} of one seed; the cell's
    entry defaults to BENCHMARK.json's, workload and config to its files."""
    import torch

    if cell is None:
        manifest = bench.load_json(bench.ROOT / "BENCHMARK.json")
        cell = bench.find_entry(manifest["workloads"], cell_name, "workload")
    workload = workload or bench.load_json(bench.HERE / "workloads" / f"{cell_name}.json")
    config = config or bench.load_json(bench.HERE / "configs" / f"{cell['config']}.json")
    with tempfile.TemporaryDirectory(prefix="mvebench-control-") as workdir:
        driver = bench.load_module("drivers", workload["driver"]).Driver(
            workload=workload, config=config, seed=seed, device=torch.device(device),
            workdir=workdir, trace=False)
        driver.setup()
        calls = []
        for spec, _ in zip(driver.specs(), range(n_calls)):
            t0 = time.perf_counter()
            work, counters = driver.call(spec)
            calls.append(bench.Call(spec, time.perf_counter() - t0, work, counters))
        driver.release()
        program = driver.judge(calls)
        control = driver.control(calls)
    return {"seed": seed, "program": program[0], "program_failed": program[2],
            "control": control[0], "control_failed": control[2], "attempted": program[1],
            "program_details": program[3], "control_details": control[3]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=3)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.calls)
        print(json.dumps(r, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
