"""The benchmark's generators repeat from a seed, and what its writers
write is what mve_tpu_torch's readers load."""

import numpy as np
import torch

from mvebench.harness import scene as gen
from mvebench.reference import dmrecon as ref_dm

torch.set_num_threads(1)
BIG_SEED = 2**31 + 12345          # larger than 32 signed bits hold
CFG = {"views": 5, "width": 96, "height": 72, "bundle_points": 300}


def point_set(seed, view=2):
    cams = gen.make_cameras(CFG["views"], gen.rng_for(seed, 0))
    return gen.point_set(cams[view], gen.textures_for(seed), 48, 36, 5e-4, 5.0, 2.5, 4,
                         gen.rng_for(seed, 4, view), torch, "cpu")


def test_generators_repeat_per_seed():
    a, b, c = point_set(BIG_SEED), point_set(BIG_SEED), point_set(BIG_SEED + 1)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["pos"], c["pos"])
    ta, tb = gen.textures_for(BIG_SEED), gen.textures_for(BIG_SEED)
    assert all(np.array_equal(x, y) for x, y in zip(ta, tb))
    cams = gen.make_cameras(7, gen.rng_for(BIG_SEED, 0))
    pa, va = gen.bundle_points(200, cams, 96, 72, gen.rng_for(BIG_SEED, 3))
    pb, vb = gen.bundle_points(200, cams, 96, 72, gen.rng_for(BIG_SEED, 3))
    assert np.array_equal(pa, pb) and np.array_equal(va, vb) and len(pa) == 200


def test_scene_loads_in_the_program(tmp_path):
    from mve_tpu_torch.core import Scene

    cams = gen.write_scene(str(tmp_path), CFG, BIG_SEED, torch, "cpu", threads=2)
    scene = Scene(str(tmp_path))
    views = scene.get_views()
    assert len(views) == CFG["views"]
    for i, (view, cam) in enumerate(zip(views, cams)):
        assert view.id == i and view.camera.valid
        np.testing.assert_allclose(view.camera.rot, cam.R, atol=0)
        np.testing.assert_allclose(view.camera.trans, cam.t, atol=0)
        np.testing.assert_allclose(view.camera.calibration(96, 72), cam.K(96, 72))
        img = view.get_image("undistorted")
        assert img.shape == (72, 96, 3) and img.dtype == np.uint8
        assert np.array_equal(img[..., 0], gen.render_gray(gen.textures_for(BIG_SEED), cam, 96, 72,
                                                           torch, "cpu"))
    bundle = scene.get_bundle()
    assert len(bundle.features) == CFG["bundle_points"]
    assert all(len(f.refs) >= 2 for f in bundle.features)


def test_point_set_loads_in_the_program(tmp_path):
    from mve_tpu_torch.fssr.sample import load_samples_from_ply

    ps = point_set(BIG_SEED)
    path = str(tmp_path / "p.ply")
    gen.write_point_set(path, ps)
    s = load_samples_from_ply(path)
    keep = ps["conf"] > 0
    assert len(s) == keep.sum()
    np.testing.assert_array_equal(s.pos, ps["pos"][keep])
    np.testing.assert_array_equal(s.scale, ps["scale"][keep])
    np.testing.assert_allclose(s.color[:, 0], ps["color"][keep] / 255.0, rtol=1e-6)
    verts, faces = gen.read_ply(path)
    assert faces == 0 and np.array_equal(verts["value"], ps["scale"])
    # Points on the planes, normals towards the camera, unit length.
    z = ps["pos"][:, 2]
    assert np.all((np.abs(z - gen.NEAR_Z) < 0.05) | (np.abs(z - gen.PLANE_Z) < 0.05))
    assert np.allclose(np.linalg.norm(ps["normal"], axis=1), 1, atol=1e-5)


def test_mvei_reader_reads_the_programs_images(tmp_path):
    from mve_tpu_torch.core import image_io

    a = np.random.default_rng(0).random((5, 7, 1)).astype(np.float32)
    image_io.save_mvei(a, str(tmp_path / "a.mvei"))
    assert np.array_equal(ref_dm.read_mvei(str(tmp_path / "a.mvei")), a)


def test_truth_depth_is_the_ray_length():
    cam = gen.make_cameras(3, gen.rng_for(1, 0))[1]
    depth = ref_dm.truth(cam, 40, 30)
    dirs, centre = gen.pixel_rays(cam, 40, 30, torch, "cpu")
    p = centre.numpy() + depth[..., None] * dirs.numpy()
    on_near = np.abs(p[..., 2] - gen.NEAR_Z) < 1e-9
    assert np.all(on_near | (np.abs(p[..., 2] - gen.PLANE_Z) < 1e-9)) and on_near.any()
    z = ref_dm.z_depth_control(cam, 40, 30)
    assert np.all(z < depth)
