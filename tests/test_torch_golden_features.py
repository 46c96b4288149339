"""The assertions of tests/test_golden_features.py, against the port on
the CPU: the reference C++ MVE's own prebundle of the seed-7 scene
(tests/golden/prebundle_ref_seed7.sfm) must be reproduced by the port's
SIFT+SURF features and per-pair matching:

  * keypoint recall: >= 95% of reference keypoints have a port keypoint
    within 2 px;
  * match reproduction: >= 90% per pair and >= 95% on average of the
    reference's verified matches appear among the port's with both
    endpoints within 2 px.

Also: mve_tpu_torch.synthetic renders the scene byte-identically to the
repository's tests/synthetic.py, so the golden file applies to it.
"""

import os

import numpy as np
import pytest
import torch

from mve_tpu_torch import synthetic
from mve_tpu_torch.core import Scene
from mve_tpu_torch.sfm.bundler.common import Viewport, load_prebundle
from mve_tpu_torch.sfm.bundler.features import Features, FeaturesOptions
from mve_tpu_torch.sfm.bundler.matching import Matching, MatchingOptions

from tests import synthetic as test_synthetic

# Test workers run side by side: one intra-op thread each keeps torch's
# OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)

GOLDEN_PREBUNDLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden", "prebundle_ref_seed7.sfm")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    kw = dict(n_views=4, width=480, height=360, seed=7, with_cameras=False)
    synthetic.make_two_plane_scene(str(root / "port"), **kw)
    test_synthetic.make_two_plane_scene(str(root / "tests"), **kw)
    return root


@pytest.fixture(scope="module")
def golden(scenes):
    ref_vps, ref_matching = load_prebundle(GOLDEN_PREBUNDLE)
    views = Scene(str(scenes / "port")).get_views()
    imgs = [v.get_image("original") for v in views]
    vps = [Viewport() for _ in views]
    Features(FeaturesOptions(use_surf=True), device="cpu").compute(imgs, vps)
    ours = Matching(MatchingOptions(), device="cpu").compute(vps)
    tol = 2.0 / max(imgs[0].shape[1], imgs[0].shape[0])  # 2 px, normalized
    return ref_vps, ref_matching, vps, ours, tol


def test_synthetic_renders_byte_identical(scenes):
    port_dir, test_dir = scenes / "port" / "views", scenes / "tests" / "views"
    names = sorted(os.listdir(test_dir))
    assert names == sorted(os.listdir(port_dir)) and len(names) == 4
    for name in names:
        for fname in ("original.png", "meta.ini"):
            assert (port_dir / name / fname).read_bytes() == \
                (test_dir / name / fname).read_bytes(), (name, fname)


def test_keypoint_recall(golden):
    ref_vps, _, vps, _, tol = golden
    for i, (rvp, ovp) in enumerate(zip(ref_vps, vps)):
        rp = np.asarray(rvp.positions)
        op = np.asarray(ovp.positions)
        assert len(op) > 0.8 * len(rp), f"view {i}: {len(op)} vs {len(rp)}"
        d = np.linalg.norm(rp[:, None, :] - op[None, :, :], axis=-1)
        recall = float((d.min(axis=1) < tol).mean())
        assert recall >= 0.95, f"view {i}: keypoint recall {recall:.3f}"


def test_match_reproduction(golden):
    ref_vps, ref_matching, vps, ours, tol = golden
    our_map = {(t.view_1_id, t.view_2_id): (t, 0, 1) for t in ours}
    our_map.update({(t.view_2_id, t.view_1_id): (t, 1, 0) for t in ours})
    rates = []
    for t in ref_matching:
        key = (t.view_1_id, t.view_2_id)
        assert key in our_map, f"pair {key} unmatched by the port"
        o, a, b = our_map[key]
        rp1 = np.asarray(ref_vps[key[0]].positions)[t.matches[:, 0]]
        rp2 = np.asarray(ref_vps[key[1]].positions)[t.matches[:, 1]]
        op1 = np.asarray(vps[key[0]].positions)[o.matches[:, a]]
        op2 = np.asarray(vps[key[1]].positions)[o.matches[:, b]]
        d1 = np.linalg.norm(rp1[:, None] - op1[None], axis=-1)
        d2 = np.linalg.norm(rp2[:, None] - op2[None], axis=-1)
        rate = float(((d1 < tol) & (d2 < tol)).any(axis=1).mean())
        rates.append(rate)
        assert rate >= 0.90, f"pair {key}: match reproduction {rate:.3f}"
    assert float(np.mean(rates)) >= 0.95
