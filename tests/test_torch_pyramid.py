"""The port's MVS image pyramid cache (mve_tpu_torch/mvs/pyramid.py).

mve_tpu's cache keys its level images on id(scene). A Scene made after
another was freed can take its address and then gets the freed scene's
images (in the 20 scenes below, mve_tpu's cache serves a stale image 19
times). The port holds a weak reference to the scene instead.
"""

import numpy as np
import torch

from mve_tpu_torch.mvs import pyramid as ppyr

# Test workers run side by side: one intra-op thread each.
torch.set_num_threads(1)


class _View:
    def __init__(self, img):
        self.img = img

    def get_image(self, embedding):
        return self.img


class _Scene:
    def __init__(self, img):
        self.views = [_View(img)]

    def get_views(self):
        return self.views


def test_pyramid_cache_never_serves_a_freed_scene():
    """Scenes made and freed one after another, each with its own image:
    every scene gets its own level images."""
    ppyr.ImagePyramidCache.cleanup()
    try:
        for i in range(20):
            scene = _Scene(np.full((8, 8), float(i), np.float32))
            got = ppyr.ImagePyramidCache.get_level(scene, 0, "undistorted", 1, lambda img: img)
            assert got.shape == (4, 4) and np.allclose(got, i, rtol=1e-5)
            del scene
    finally:
        ppyr.ImagePyramidCache.cleanup()
