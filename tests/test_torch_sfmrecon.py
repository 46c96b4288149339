"""The port's sfmrecon --skip-sfm against mve_tpu's, on the CPU: the same
4-view 320x240 scene through both packages' sfm_reconstruct(skip_sfm=True),
compared prebundle to prebundle; and each package loads the other's file.

Tolerances: per view, at least 99% of mve_tpu's keypoints have a port
keypoint within 0.5 px; the same connected pairs; per pair, at least 99%
of mve_tpu's verified matches reproduced with both endpoints within
0.5 px. Identical output is what is measured; the margin covers summation
order and LAPACK differences between the two packages.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mve_tpu.apps import sfmrecon as jax_sfmrecon
from mve_tpu.sfm.bundler.common import load_prebundle as jax_load, save_prebundle as jax_save

from mve_tpu_torch.apps import sfmrecon
from mve_tpu_torch.sfm.bundler.common import load_prebundle, save_prebundle

from tests.synthetic import make_two_plane_scene

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


def test_incremental_sfm_not_ported(runs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sfmrecon.sfm_reconstruct(str(runs[0] / "port"), device="cpu")


def test_cuda_default_raises_without_a_card(runs):
    if torch.cuda.is_available():
        return  # the default device is legitimate where a card exists
    scene = runs[0] / "fresh"
    shutil.copytree(runs[0] / "jax", scene)
    os.remove(scene / "prebundle.sfm")
    with pytest.raises(RuntimeError, match="CUDA"):
        sfmrecon.sfm_reconstruct(str(scene), skip_sfm=True, verbose=False)
    assert not (scene / "prebundle.sfm").exists()
