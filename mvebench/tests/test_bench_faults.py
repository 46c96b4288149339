"""A run with its timed path broken underneath comes out not correct.

Each case drives bench.run_cell on the CPU (the run's look for a card is
main()'s, and is skipped) at a small size of the cell, once sound and
once for each fault a cell of its kind can have: a step that returns its
state unchanged, half of the work left out, an answer altered where it
is produced (no cell spans chips, so no exchange can be left out); for
dmrecon also half of each view's depths dropped, and for fssrecon an
octree one level shallower and a surface vertex moved off the scene.
The limits here are set from the sound run's readings at this size (the
committed limits are for the cell's own size, where fills and surfaces
are better; see limit()); the sound run has to pass them and each fault
has to fail."""

import contextlib
import time

import pytest
import torch

from mvebench.harness import bench
from mvebench.tests.cells import entry

torch.set_num_threads(4)
MANIFEST = bench.load_json(bench.ROOT / "BENCHMARK.json")


def small(cell_name):
    cell = entry(cell_name)
    workload = bench.load_json(bench.HERE / "workloads" / f"{cell_name}.json")
    config = bench.load_json(bench.HERE / "configs" / f"{cell['config']}.json")
    if workload["driver"] == "dmrecon":
        config.update(views=6, width=480, height=round(480 * config["height"] / config["width"]),
                      bundle_points=800)
        workload["views_per_call"] = 2
    else:
        config.update(views=4, width=480, height=360, fssrecon_views_per_call=2)
        workload["checked_corners"] = 128
    return cell, workload, config


def run(cell, workload, config, workdir, limits):
    workdir.mkdir()
    workload = dict(workload, limits=limits)
    return bench.run_cell(cell, workload, config, MANIFEST, 20261017, 1e-3, False, "cpu",
                          str(workdir), time.perf_counter())


def limit(name, sound, committed):
    """The test's limit of a number from the sound run's reading: 0 where
    the committed limit is exact; a quarter of the way from the reading
    to 1 for a share of a view's pixels (doubling a share near a half
    says nothing); twice the reading otherwise."""
    if committed == 0:
        return 0.0
    if name in ("bad_share", "seen_bad_share"):
        return sound + (1.0 - sound) / 4
    return max(2.0 * sound, 1e-3)


@contextlib.contextmanager
def patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def dmrecon_faults():
    from mve_tpu_torch.apps import dmrecon as app
    from mve_tpu_torch.mvs import dmrecon as mvs
    from mve_tpu_torch.mvs import sweep_solver

    def unchanged(real):
        def solve(*args, **kwargs):
            init = args[13]
            B, H, W = init.shape
            return (init, torch.ones_like(init), torch.zeros(B, H, W, 2),
                    torch.full((B,), H * W))
        return solve

    def half(real):
        return lambda path, view_ids=None, **kw: real(path, view_ids=set(sorted(view_ids)[::2]), **kw)

    def altered(real):
        def run_batch(prepared, *args, **kwargs):
            depth, conf, dz, n = real(prepared, *args, **kwargs)
            for b, p in enumerate(prepared):
                if p["view_id"] % 2 == 1:
                    depth[b] *= 1.1
            return depth, conf, dz, n
        return run_batch

    def dropped(real):
        def run_batch(prepared, *args, **kwargs):
            depth, conf, dz, n = real(prepared, *args, **kwargs)
            depth[:, ::2] = 0
            conf[:, ::2] = 0
            return depth, conf, dz, n
        return run_batch

    return {"state unchanged": (sweep_solver, "solve_batch_sweep", unchanged),
            "half the views left out": (app, "reconstruct_views", half),
            "an answer altered": (mvs, "_run_batch", altered),
            "half of each view's depths dropped": (mvs, "_run_batch", dropped)}


def fssrecon_faults():
    from mve_tpu_torch.fssr import block_eval, dual_contouring

    def unchanged(real):
        return lambda *args, **kwargs: None

    def half(real):
        return lambda part, samples, *a, **kw: real(part, samples.subset(slice(0, None, 2)), *a, **kw)

    def altered(real):
        def evaluate(*args, **kwargs):
            sums = real(*args, **kwargs)
            sums[:, 0] *= 1.01
            return sums
        return evaluate

    def shallower(real):
        def build(samples, max_level=10, **kwargs):
            finest = int(real(samples, max_level=max_level, **kwargs).leaf_level.max())
            return real(samples, max_level=finest - 1, **kwargs)
        return build

    def displaced(real):
        def extract(self):
            mesh = real(self)
            mesh.vertices[int(mesh.vertex_confidences.argmax()), 2] += 1.0
            return mesh
        return extract

    return {"state unchanged": (block_eval, "run_chunk", unchanged),
            "half the samples left out": (block_eval, "run_chunk", half),
            "an answer altered": (block_eval, "evaluate_positions_blocked", altered),
            "an octree one level shallower": (dual_contouring, "build_octree", shallower),
            "a surface vertex displaced": (dual_contouring.DualContouring, "extract_mesh",
                                           displaced)}


@pytest.mark.parametrize("cell_name,faults", [("dtu49-dmrecon-s2", dmrecon_faults),
                                              ("fountain11-dmrecon-s2", dmrecon_faults),
                                              ("dtu49-fssrecon", fssrecon_faults)])
def test_faults_come_out_not_correct(cell_name, faults, tmp_path):
    cell, workload, config = small(cell_name)
    sound = run(cell, workload, config, tmp_path / "sound", dict.fromkeys(workload["limits"], 1.0))
    limits = {k: limit(k, c["value"], workload["limits"][k]) for k, c in sound["checks"].items()}
    assert run(cell, workload, config, tmp_path / "again", limits)["correct"]
    for name, (module, attr, make) in faults().items():
        with patched(module, attr, make):
            broken = run(cell, workload, config, tmp_path / name.replace(" ", "_"), limits)
        assert not broken["correct"], (name, broken["checks"], limits)
