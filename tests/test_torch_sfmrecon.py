"""The port's sfmrecon against mve_tpu's, on the CPU, on the same 4-view
320x240 scene: with --skip-sfm, compared prebundle to prebundle; and the
whole app (features to synth_0.out and the undistorted images), the port
through its command line. Each package loads the other's files.

Tolerances, prebundle: per view, at least 99% of mve_tpu's keypoints have
a port keypoint within 0.5 px; the same connected pairs; per pair, at
least 99% of mve_tpu's verified matches reproduced with both endpoints
within 0.5 px. Identical output is what is measured; the margin covers
summation order and LAPACK differences between the two packages.
Whole app: the same number of cameras, track counts within 1%, camera
centres within 1% of their extent after a similarity alignment (and
within 2% of the generator's true cameras, as tests/test_sfm_pipeline.py
holds mve_tpu), undistorted images within 1 grey level.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mve_tpu.apps import sfmrecon as jax_sfmrecon
from mve_tpu.core import Scene as JScene
from mve_tpu.core.bundle_io import load_mve_bundle as jax_load_bundle
from mve_tpu.core.bundle_io import save_mve_bundle as jax_save_bundle
from mve_tpu.sfm.bundler.common import load_prebundle as jax_load, save_prebundle as jax_save
from mve_tpu.sfm.bundler.incremental import _determine_similarity

from mve_tpu_torch.apps import sfmrecon
from mve_tpu_torch.core import Scene
from mve_tpu_torch.core.bundle_io import load_mve_bundle, save_mve_bundle
from mve_tpu_torch.sfm.bundler.common import load_prebundle, save_prebundle

from tests.synthetic import make_cameras, make_two_plane_scene

# Test workers run side by side: one intra-op thread each keeps torch's
# OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)

W, H = 320, 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sfmrecon")
    make_two_plane_scene(str(root / "jax"), n_views=4, width=W, height=H, seed=7,
                         with_cameras=False)
    shutil.copytree(root / "jax", root / "port")
    jax_sfmrecon.sfm_reconstruct(str(root / "jax"), skip_sfm=True, verbose=False)
    jax_timings = dict(jax_sfmrecon.LAST_TIMINGS)
    # The port through its command line, as a user runs it.
    assert sfmrecon.main(["--skip-sfm", "--device", "cpu", str(root / "port")]) == 0
    return root, jax_timings, dict(sfmrecon.LAST_TIMINGS)


def test_prebundles_agree(runs):
    root, jax_timings, timings = runs
    jv, jm = jax_load(str(root / "jax" / "prebundle.sfm"))
    pv, pm = load_prebundle(str(root / "port" / "prebundle.sfm"))
    tol = 0.5 / max(W, H)
    assert len(pv) == len(jv) == 4
    for i, (j, p) in enumerate(zip(jv, pv)):
        d = np.linalg.norm(j.positions[:, None] - p.positions[None], axis=-1)
        assert float((d.min(axis=1) < tol).mean()) >= 0.99, f"view {i}"
    assert sorted((m.view_1_id, m.view_2_id) for m in pm) == \
        sorted((m.view_1_id, m.view_2_id) for m in jm)
    assert len(pm) >= 5
    pmap = {(m.view_1_id, m.view_2_id): m for m in pm}
    for m in jm:
        a, b = m.view_1_id, m.view_2_id
        o = pmap[(a, b)]
        d1 = np.linalg.norm(jv[a].positions[m.matches[:, 0]][:, None]
                            - pv[a].positions[o.matches[:, 0]][None], axis=-1)
        d2 = np.linalg.norm(jv[b].positions[m.matches[:, 1]][:, None]
                            - pv[b].positions[o.matches[:, 1]][None], axis=-1)
        rate = float(((d1 < tol) & (d2 < tol)).any(axis=1).mean())
        assert rate >= 0.99, f"pair {(a, b)}: {rate:.4f}"
    for key in ("features_ms", "matching_ms", "n_features"):
        assert key in timings
    assert timings["n_features"] == jax_timings["n_features"]


def test_prebundle_files_interchange(runs, tmp_path):
    """A prebundle written by either package loads in the other, and
    writing it back gives the same bytes."""
    root = runs[0]
    for src, load, save in ((root / "jax" / "prebundle.sfm", load_prebundle, save_prebundle),
                            (root / "port" / "prebundle.sfm", jax_load, jax_save)):
        vps, matching = load(str(src))
        assert len(vps) == 4 and matching
        out = tmp_path / "copy.sfm"
        save(vps, matching, str(out))
        assert out.read_bytes() == src.read_bytes()


def test_existing_prebundle_is_kept(runs):
    path = runs[0] / "port" / "prebundle.sfm"
    before = path.read_bytes()
    sfmrecon.sfm_reconstruct(str(runs[0] / "port"), skip_sfm=True, verbose=False,
                             device="cpu")
    assert path.read_bytes() == before


def test_incremental_sfm_not_ported(runs, tmp_path):
    """Incremental SfM is ported now: given a scene that already has a
    prebundle, the app loads it (computes no features) and goes on to
    SfM, as mve_tpu's does."""
    scene = tmp_path / "scene"
    shutil.copytree(runs[0] / "port", scene)
    before = (scene / "prebundle.sfm").read_bytes()
    sfmrecon.sfm_reconstruct(str(scene), verbose=False, device="cpu")
    assert (scene / "prebundle.sfm").read_bytes() == before
    assert "features_ms" not in sfmrecon.LAST_TIMINGS
    assert sfmrecon.LAST_TIMINGS["n_cameras"] == 4
    assert len(load_mve_bundle(str(scene / "synth_0.out")).cameras) == 4


def test_full_app_raises_without_a_card(runs, tmp_path):
    if torch.cuda.is_available():
        return  # the default device is legitimate where a card exists
    scene = tmp_path / "scene"
    shutil.copytree(runs[0] / "port", scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        sfmrecon.sfm_reconstruct(str(scene), verbose=False)
    assert not (scene / "synth_0.out").exists()


def test_cuda_default_raises_without_a_card(runs):
    if torch.cuda.is_available():
        return  # the default device is legitimate where a card exists
    scene = runs[0] / "fresh"
    shutil.copytree(runs[0] / "jax", scene)
    os.remove(scene / "prebundle.sfm")
    with pytest.raises(RuntimeError, match="CUDA"):
        sfmrecon.sfm_reconstruct(str(scene), skip_sfm=True, verbose=False)
    assert not (scene / "prebundle.sfm").exists()


@pytest.fixture(scope="module")
def full_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sfmrecon_full")
    make_two_plane_scene(str(root / "jax"), n_views=4, width=W, height=H, seed=7,
                         with_cameras=False)
    shutil.copytree(root / "jax", root / "port")
    jax_sfmrecon.sfm_reconstruct(str(root / "jax"), verbose=False)
    jax_timings = dict(jax_sfmrecon.LAST_TIMINGS)
    assert sfmrecon.main(["--device", "cpu", str(root / "port")]) == 0
    return root, jax_timings, dict(sfmrecon.LAST_TIMINGS)


def _bundle_centres(bundle):
    return np.array([-c.rot.astype(np.float64).T @ c.trans.astype(np.float64)
                     for c in bundle.cameras if c.flen > 0])


def _aligned_error(est, ref):
    R, s, t = _determine_similarity(est, ref)
    aligned = (s * (R @ est.T)).T + t
    return np.linalg.norm(aligned - ref, axis=1).max() / np.linalg.norm(ref.max(0) - ref.min(0))


def test_full_app_agrees(full_runs):
    root, jt, pt = full_runs
    assert pt["n_cameras"] == jt["n_cameras"] == 4
    assert abs(pt["n_tracks"] - jt["n_tracks"]) <= 0.01 * jt["n_tracks"]
    for key in ("incremental_ms", "incremental_phases", "undistort_ms", "ba_totals"):
        assert key in pt
    jb = jax_load_bundle(str(root / "jax" / "synth_0.out"))
    pb = load_mve_bundle(str(root / "port" / "synth_0.out"))
    assert _aligned_error(_bundle_centres(pb), _bundle_centres(jb)) < 0.01
    truth = np.array([-c.rot.astype(np.float64).T @ c.trans.astype(np.float64)
                      for c in make_cameras(4, spread=0.55, seed=7)])
    assert _aligned_error(_bundle_centres(pb), truth) < 0.02


def test_bundle_files_interchange(full_runs, tmp_path):
    """Each package's load_mve_bundle reads the other's synth_0.out, and
    writing it back gives the same bytes."""
    root = full_runs[0]
    for src, load, save in ((root / "jax" / "synth_0.out", load_mve_bundle, save_mve_bundle),
                            (root / "port" / "synth_0.out", jax_load_bundle, jax_save_bundle)):
        bundle = load(str(src))
        assert len(bundle.cameras) == 4 and len(bundle.features) > 50
        out = tmp_path / "copy.out"
        save(bundle, str(out))
        assert out.read_bytes() == src.read_bytes()
    # The scenes load through each other's Scene as well.
    assert len(Scene(str(root / "jax")).get_bundle().cameras) == 4
    assert len(JScene(str(root / "port")).get_bundle().cameras) == 4


def test_undistorted_images_agree(full_runs):
    root = full_runs[0]
    jviews = JScene(str(root / "jax")).get_views()
    pviews = Scene(str(root / "port")).get_views()
    for jv, pv in zip(jviews, pviews):
        a = jv.get_byte_image("undistorted")
        b = pv.get_byte_image("undistorted")
        assert a is not None and b is not None and a.shape == b.shape
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
        assert pv.camera.flen > 0
