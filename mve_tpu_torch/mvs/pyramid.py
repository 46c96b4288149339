"""Process-wide image pyramid cache (reference: libs/dmrecon/image_pyramid.cc
ImagePyramidCache — mutex-guarded cache keyed on (scene, embedding)).

Caches per-view grayscale level images so neighbor views are converted
and downsampled once per dmrecon batch instead of once per reference
view. Entries are plain numpy arrays; eviction by generation when a new
scene/embedding key appears (the reference's cache keeps one scene too).
The scene is held by a weak reference and compared by identity: mve_tpu
keys on id(scene), which a later Scene can reuse once the first is freed,
and then serves the freed scene's images.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Tuple

import numpy as np

from ..utils.tracing import count, span


def half_size_gaussian_np(img: np.ndarray) -> np.ndarray:
    """Pure-numpy Gaussian 4x4-tap half-size, numerically identical to
    image_tools.rescale_half_size_gaussian (image_tools.h:619), run on the
    host as mve_tpu runs it, so both packages see the same level images.

    img: (H, W) or (H, W, C) float."""
    import math

    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w = img.shape[:2]
    sigma2 = 2.0  # sigma = sqrt(1), 2*sigma^2
    a = math.sqrt(math.exp(-4.5 / sigma2))
    b = math.sqrt(math.exp(-0.5 / sigma2))
    kern = np.array([a, b, b, a], img.dtype)
    kern /= kern.sum()
    padded = np.pad(img, ((1, 2 + h % 2), (1, 2 + w % 2), (0, 0)),
                    mode="edge")
    oh, ow = (h + 1) // 2, (w + 1) // 2
    acc = np.zeros((oh, ow, img.shape[2]), img.dtype)
    for dy in range(4):
        rowsel = padded[dy : dy + 2 * oh : 2]
        inner = np.zeros_like(acc)
        for dx in range(4):
            inner += kern[dx] * rowsel[:, dx : dx + 2 * ow : 2]
        acc += kern[dy] * inner
    return acc[:, :, 0] if squeeze else acc


class ImagePyramidCache:
    _lock = threading.Lock()
    _scene: weakref.ref | None = None
    _embedding: str | None = None
    _levels: Dict[Tuple[int, int], np.ndarray] = {}

    @classmethod
    def get_level(cls, scene, view_id: int, embedding: str, level: int,
                  to_gray) -> np.ndarray:
        """Return the level-`level` grayscale image of a view, cached. A
        hit counts `level_hits` on the open span; a miss is an
        mvs.load_level span, counting `images_decoded` and `bytes_decoded`
        (a level-0 miss) and `halvings`."""
        with cls._lock:
            if (cls._scene is None or cls._scene() is not scene
                    or cls._embedding != embedding):
                cls._scene, cls._embedding = weakref.ref(scene), embedding
                cls._levels = {}
            cached = cls._levels.get((view_id, level))
        if cached is not None:
            count("level_hits")
            return cached
        with span("mvs.load_level"):
            # Build from the nearest cached coarser... simplest: from level 0.
            with cls._lock:
                base = cls._levels.get((view_id, 0))
            if base is None:
                image = scene.get_views()[view_id].get_image(embedding)
                count("images_decoded")
                count("bytes_decoded", image.nbytes)
                base = to_gray(image)
                with cls._lock:
                    cls._levels[(view_id, 0)] = base
            img = base
            for lv in range(1, level + 1):
                with cls._lock:
                    nxt = cls._levels.get((view_id, lv))
                if nxt is None:
                    nxt = half_size_gaussian_np(img)
                    count("halvings")
                    with cls._lock:
                        cls._levels[(view_id, lv)] = nxt
                img = nxt
            return img

    @classmethod
    def cleanup(cls) -> None:
        with cls._lock:
            cls._scene = cls._embedding = None
            cls._levels = {}
