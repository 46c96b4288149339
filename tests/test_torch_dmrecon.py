"""The port's dmrecon app against mve_tpu's, on the CPU, on the same
5-view 192x144 plane scene (tests/synthetic.py, mve_tpu's synth_0.out
and cameras) at scale 1 (depth maps of 96x72).

Tolerances: per-view fill within 0.005 of mve_tpu's, median relative
depth difference on pixels both accept below 0.005; the same embedding
names, shapes and dtypes; undist-L1 identical. Each package reads the
other's MVEI files. --master-view, --force and skipping existing depth
maps, DMRecon's progress and cancellation behave alike, and the entry
points default to the card. DMRecon.start on one view writes what
reconstruct_batch writes for it, bit for bit, under the same spans.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from mve_tpu.apps import dmrecon as jax_app
from mve_tpu.core import Scene as JScene
from mve_tpu.core import image_io as jio
from mve_tpu.mvs import DMRecon as JDMRecon, Settings as JSettings
from mve_tpu.mvs import dmrecon as jdm
from mve_tpu.mvs.progress import ReconStatus as JStatus

from mve_tpu_torch.apps import dmrecon as app
from mve_tpu_torch.core import Scene
from mve_tpu_torch.core import depthmap, image_io
from mve_tpu_torch.interop import mvs_settings_from_dict
from mve_tpu_torch.mvs import DMRecon
from mve_tpu_torch.mvs import dmrecon as pdm
from mve_tpu_torch.mvs.progress import ReconStatus
from mve_tpu_torch.utils import tracing

from tests.synthetic import make_plane_scene

torch.set_num_threads(1)

EMBEDDINGS = ("depth-L1", "conf-L1", "dz-L1", "undist-L1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dmrecon")
    make_plane_scene(str(root / "jax"), n_views=5, width=192, height=144)
    shutil.copytree(root / "jax", root / "port")
    shutil.copytree(root / "jax", root / "fresh")
    assert jax_app.reconstruct_views(str(root / "jax"), scale=1, verbose=False) == 5
    jax_stats = dict(jax_app.LAST_STATS)
    # The port through its command line, as a user runs it.
    assert app.main(["-s1", "--progress", "silent", "--device", "cpu", str(root / "port")]) == 0
    return root, jax_stats, dict(app.LAST_STATS), dict(pdm.LAST_TIMINGS)


def test_depth_maps_agree(runs):
    root, jstats, pstats, timings = runs
    jviews, pviews = JScene(str(root / "jax")).get_views(), Scene(str(root / "port")).get_views()
    for i, (jv, pv) in enumerate(zip(jviews, pviews)):
        jd = jv.get_image("depth-L1")[..., 0]
        pd = pv.get_image("depth-L1")[..., 0]
        assert abs((jd > 0).mean() - (pd > 0).mean()) <= 0.005, i
        assert abs(jstats["per_view_fills"][i] - pstats["per_view_fills"][i]) <= 0.005
        both = (jd > 0) & (pd > 0)
        assert both.mean() > 0.3
        rel = np.abs(jd[both] - pd[both]) / jd[both]
        assert np.median(rel) < 0.005, (i, np.median(rel))
    assert set(jstats) == set(pstats)
    assert set(timings) >= {"prepare_ms", "solve_ms", "write_ms", "batches"}


def test_embeddings_alike(runs):
    root = runs[0]
    for jv, pv in zip(JScene(str(root / "jax")).get_views(), Scene(str(root / "port")).get_views()):
        for name in EMBEDDINGS:
            a, b = jv.get_image(name), pv.get_image(name)
            assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(jv.get_image("undist-L1"), pv.get_image("undist-L1"))
        d = jv.get_directory(), pv.get_directory()
        assert sorted(os.listdir(d[0])) == sorted(os.listdir(d[1]))


def test_mvei_files_interchange(runs, tmp_path):
    """Each package's MVEI reader loads the other's depth maps, and writing
    them back gives the same bytes."""
    root = runs[0]
    for src_pkg, load, save in (("jax", image_io.load_image, image_io.save_image),
                                ("port", jio.load_image, jio.save_image)):
        for name in ("depth-L1", "dz-L1"):
            src = root / src_pkg / "views" / "view_0002.mve" / f"{name}.mvei"
            img = load(str(src))
            out = tmp_path / f"{src_pkg}-{name}.mvei"
            save(img, str(out))
            assert out.read_bytes() == src.read_bytes()


def test_skip_force_and_master_view(runs, tmp_path):
    root = runs[0]
    for pkg in ("jax", "port"):
        shutil.copytree(root / pkg, tmp_path / pkg)
    # Everything exists: both skip every view.
    assert jax_app.reconstruct_views(str(tmp_path / "jax"), scale=1, verbose=False) == 0
    assert app.reconstruct_views(str(tmp_path / "port"), scale=1, verbose=False, device="cpu") == 0
    # --master-view with --force redoes exactly that view.
    before = {pkg: {i: (tmp_path / pkg / "views" / f"view_{i:04d}.mve" / "depth-L1.mvei").read_bytes()
                    for i in range(5)} for pkg in ("jax", "port")}
    jax_app.main(["-s1", "-m", "3", "--force", "--progress", "silent", str(tmp_path / "jax")])
    app.main(["-s1", "-m", "3", "--force", "--progress", "silent", "--device", "cpu",
              str(tmp_path / "port")])
    for pkg in ("jax", "port"):
        after = {i: (tmp_path / pkg / "views" / f"view_{i:04d}.mve" / "depth-L1.mvei").read_bytes()
                 for i in range(5)}
        assert all(after[i] == before[pkg][i] for i in (0, 1, 2, 4)), pkg
    assert jax_app.LAST_STATS["per_view_fills"].keys() == app.LAST_STATS["per_view_fills"].keys() == {3}
    assert abs(jax_app.LAST_STATS["depth_fill"] - app.LAST_STATS["depth_fill"]) <= 0.005


def test_dmrecon_progress_and_cancel(runs):
    root = runs[0]
    js = JSettings(ref_view_nr=1, scale=1, quiet=True)
    ps = mvs_settings_from_dict(dataclasses.asdict(js))
    jr = JDMRecon(JScene(str(root / "fresh")), js)
    pr = DMRecon(Scene(str(root / "fresh")), ps, device="cpu")
    jr.start()
    pr.start()
    assert jr.progress.status == JStatus.IDLE and pr.progress.status == ReconStatus.IDLE
    assert abs(jr.filled_ratio - pr.filled_ratio) <= 0.005
    assert abs(jr.progress.filled - pr.progress.filled) <= 0.005 * 96 * 72
    for recon, status in ((JDMRecon(JScene(str(root / "fresh")), js), JStatus),
                          (DMRecon(Scene(str(root / "fresh")), ps, device="cpu"), ReconStatus)):
        recon.progress.cancelled = True
        with pytest.raises(RuntimeError, match="cancelled"):
            recon.start()
        assert recon.progress.status == status.CANCELLED


def test_start_is_reconstruct_batch_of_one_view(runs):
    """DMRecon.start writes the same depth, confidence and dz maps as
    reconstruct_batch on that view, bit for bit, and opens the same
    spans: mvs.prepare, one mvs.solve, mvs.write; it sets LAST_TIMINGS."""
    root = runs[0]
    s = pdm.Settings(ref_view_nr=3, scale=1, quiet=True)
    recon = DMRecon(Scene(str(root / "fresh")), s, device="cpu")
    pdm.LAST_TIMINGS.clear()
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            recon.start()
        recs = list(tracing.records())
    finally:
        tracing.clear()
    timings = dict(pdm.LAST_TIMINGS)
    scene = Scene(str(root / "fresh"))
    fills = pdm.reconstruct_batch(scene, s, [(3, 1)], verbose=False, device="cpu")
    assert fills == {3: recon.filled_ratio} and recon.filled_ratio > 0.3
    for name in ("depth-L1", "conf-L1", "dz-L1"):
        a = recon.scene.get_views()[3].get_image(name)
        b = scene.get_views()[3].get_image(name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # The outermost of these records: a span another test left open on
    # this thread would be their parent.
    ids = {r.id for r in recs}
    top = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r.parent not in ids]
    assert top == ["mvs.prepare", "mvs.solve", "mvs.write"]
    (solve,) = [r for r in recs if r.name == "mvs.solve"]
    assert solve.counters.get("views_sweep") == 1
    assert set(timings) == {"prepare_ms", "solve_ms", "write_ms", "batches"}
    assert all(timings[k] > 0 for k in ("prepare_ms", "solve_ms", "write_ms"))
    assert [b[:4] for b in timings["batches"]] == [(1, "sweep", 72, 96)]


def test_write_ply_like_mve_tpu(runs, tmp_path):
    """dmrecon -p: the same depth map gives the same PLY bytes."""
    root = runs[0]
    jv = JScene(str(root / "port")).get_views()[2]
    pv = Scene(str(root / "port")).get_views()[2]
    depth = pv.get_image("depth-L1")[..., 0]
    for pkg, module, view in (("jax", jdm, jv), ("port", pdm, pv)):
        s = dataclasses.replace(JSettings() if pkg == "jax" else pdm.Settings(),
                                ref_view_nr=2, scale=1, ply_path=str(tmp_path / pkg))
        module._write_ply_for(view, s, depth)
    a = (tmp_path / "jax" / "view_0002-L1.ply").read_bytes()
    assert a == (tmp_path / "port" / "view_0002-L1.ply").read_bytes() and len(a) > 1000


def test_entry_points_default_to_the_card(runs, tmp_path):
    if torch.cuda.is_available():
        return  # the default device is legitimate where a card exists
    root = runs[0]
    scene = tmp_path / "scene"
    shutil.copytree(root / "fresh", scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.reconstruct_views(str(scene), scale=1, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(["-s1", str(scene)])
    with pytest.raises(RuntimeError, match="CUDA"):
        DMRecon(Scene(str(scene)), pdm.Settings(scale=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        depthmap.depthmap_bilateral_filter(np.ones((4, 4), np.float32))
    assert not (scene / "views" / "view_0000.mve" / "depth-L1.mvei").exists()
