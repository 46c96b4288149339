"""The controls against the committed limits (controls.py): at a small
size on the CPU the control comes out not correct; at the cell's own
size on the card (marker `chip`) the program's run passes every limit
and the control's does not, on three seeds with three calls a seed."""

import pytest
import torch

from mvebench import controls
from mvebench.harness import bench
from mvebench.tests.cells import UNLISTED, entry

torch.set_num_threads(4)
MANIFEST = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("cell_name", CELLS + [c["name"] for c in UNLISTED])
def test_control_fails_at_a_small_size(cell_name):
    cell = entry(cell_name)
    workload = bench.load_json(bench.HERE / "workloads" / f"{cell_name}.json")
    config = bench.load_json(bench.HERE / "configs" / f"{cell['config']}.json")
    config.update(views=4, width=320, height=240, bundle_points=600, fssrecon_views_per_call=2)
    workload.update(views_per_call=2, checked_corners=64)
    r = controls.readings(cell_name, 11, 1, "cpu", workload, config, cell)
    assert r["control_failed"] == r["attempted"] > 0, r["control"]


@pytest.mark.chip
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_where_the_program_passes(cell_name, card):
    for seed in (7001, 7002, 7003):
        r = controls.readings(cell_name, seed, 3, "cuda")
        assert r["program_failed"] == 0, r["program"]
        assert all(c["value"] <= c["limit"] for c in r["program"].values()), r["program"]
        assert r["control_failed"] > 0, r["control"]
