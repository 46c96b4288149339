"""The cells the tests run: those BENCHMARK.json lists, and those whose
files the benchmark keeps but does not list yet (dtu49-fssrecon: its
runs spread too widely for a bound; see PERF.md), with the entry that
would list them."""

from mvebench.harness import bench

MANIFEST = bench.load_json(bench.ROOT / "BENCHMARK.json")
UNLISTED = [{"name": "dtu49-fssrecon", "config": "dtu49", "traffic": "fssrecon-triples",
             "chips": 1}]


def entry(cell_name: str) -> dict:
    for cell in UNLISTED:
        if cell["name"] == cell_name:
            return cell
    return bench.find_entry(MANIFEST["workloads"], cell_name, "workload")
