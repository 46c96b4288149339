"""Process-wide image pyramid cache (reference: libs/dmrecon/image_pyramid.cc
ImagePyramidCache — mutex-guarded cache keyed on (scene, embedding)).

Caches per-view grayscale level images so neighbor views are converted
and downsampled once per dmrecon batch instead of once per reference
view. Entries are plain numpy arrays; eviction by generation when a new
scene/embedding key appears (the reference's cache keeps one scene too).
On a CUDA device a miss builds its level with the kernels of
ops/pyramid.py, bit-identical to the numpy path here, which runs for a CPU
device.
The scene is held by a weak reference and compared by identity: mve_tpu
keys on id(scene), which a later Scene can reuse once the first is freed,
and then serves the freed scene's images.
`prefetch` starts a view's missing image decodes together on a pool of
host threads; `get_level` still builds and caches the levels one at a
time, in the caller's order, on the calling thread.
"""

from __future__ import annotations

import math
import os
import threading
import warnings
import weakref
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import image_tools
from ..utils.tracing import count, span


def _to_gray(img: np.ndarray) -> np.ndarray:
    """Host-side gray conversion (mvs_tools desaturate-luminance)."""
    f = image_tools.to_float(img)
    if f.shape[2] >= 3:
        return (0.30 * f[:, :, 0] + 0.59 * f[:, :, 1]
                + 0.11 * f[:, :, 2]).astype(np.float32)
    return f[:, :, 0]


def half_size_taps(dtype) -> np.ndarray:
    """The four normalised taps of a Gaussian half-size, in `dtype`."""
    sigma2 = 2.0  # sigma = sqrt(1), 2*sigma^2
    a = math.sqrt(math.exp(-4.5 / sigma2))
    b = math.sqrt(math.exp(-0.5 / sigma2))
    kern = np.array([a, b, b, a], dtype)
    kern /= kern.sum()
    return kern


def half_size_gaussian_np(img: np.ndarray) -> np.ndarray:
    """Pure-numpy Gaussian 4x4-tap half-size, numerically identical to
    image_tools.rescale_half_size_gaussian (image_tools.h:619), run on the
    host as mve_tpu runs it, so both packages see the same level images.

    img: (H, W) or (H, W, C) float."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w = img.shape[:2]
    kern = half_size_taps(img.dtype)
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
    _pending: Dict[int, Future] = {}      # view id -> its image's decode in the pool
    _pool: Optional[ThreadPoolExecutor] = None

    @classmethod
    def _select(cls, scene, embedding: str) -> None:
        """Key the cache on (scene, embedding): a new key empties it, once
        the decodes still in flight for the old one are done. Call under
        _lock."""
        if (cls._scene is None or cls._scene() is not scene
                or cls._embedding != embedding):
            wait(cls._pending.values())
            cls._scene, cls._embedding = weakref.ref(scene), embedding
            cls._levels, cls._pending = {}, {}

    @classmethod
    def prefetch(cls, scene, view_ids, embedding: str, level: int) -> None:
        """Start decoding the images of the views in `view_ids` whose level
        `level` misses the cache, and whose level 0 (what the CPU path
        builds from) does too, together on a pool of host threads, if
        there are two or more such views; get_level then takes each from
        the pool. A lone miss is left to get_level to decode inline. The
        pool, made at the first use, has a thread for each CPU this
        process may run on, so min(misses, CPUs) decodes run at once. A
        worker only calls its view's get_image."""
        views = scene.get_views()
        with cls._lock:
            cls._select(scene, embedding)
            misses = [v for v in dict.fromkeys(view_ids)
                      if v not in cls._pending and (v, level) not in cls._levels
                      and (v, 0) not in cls._levels]
            if len(misses) < 2:
                return
            if cls._pool is None:
                cls._pool = ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                               thread_name_prefix="mvs-decode")
            for v in misses:
                cls._pending[v] = cls._pool.submit(views[v].get_image, embedding)

    @classmethod
    def _drain(cls) -> None:
        """Wait for every decode in flight, and forget them with their
        errors: none outlives the call that failed."""
        with cls._lock:
            pending, cls._pending = cls._pending, {}
        wait(pending.values())

    @classmethod
    def _decode(cls, scene, view_id: int, embedding: str) -> np.ndarray:
        """The view's image, from its decode in the pool if prefetch started
        one (its error, if it failed, raised here), else decoded here;
        counts images_decoded, bytes_decoded and images_prefetched (1 if it
        came from the pool) on the open span."""
        with cls._lock:
            future = cls._pending.pop(view_id, None)
        if future is None:
            image = scene.get_views()[view_id].get_image(embedding)
        else:
            image = future.result()
        count("images_decoded")
        count("bytes_decoded", image.nbytes)
        count("images_prefetched", int(future is not None))
        return image

    @classmethod
    def get_level(cls, scene, view_id: int, embedding: str, level: int,
                  to_gray, device="cpu") -> np.ndarray:
        """Return the level-`level` grayscale image of a view, cached. A
        hit counts `level_hits` on the open span; a miss is an
        mvs.load_level span, counting `images_decoded`, `bytes_decoded`
        and `images_prefetched` (a decode), `halvings` and
        `levels_built_on_device`. A miss that fails waits for the other
        decodes in flight (prefetch) before its error propagates.

        device: where a miss is built. On the CPU, with numpy, from the
        view's cached gray plane and coarser levels. On a CUDA device, by
        the kernels of ops/pyramid.py from the decoded image, which then
        compute `_to_gray` (the only `to_gray` they take); only
        the requested level comes back to the host and is cached."""
        with cls._lock:
            cls._select(scene, embedding)
            cached = cls._levels.get((view_id, level))
        if cached is not None:
            count("level_hits")
            return cached
        try:
            if torch.device(device).type == "cuda":
                return cls._build_on_device(scene, view_id, embedding, level, to_gray,
                                            torch.device(device))
            return cls._build_on_host(scene, view_id, embedding, level, to_gray)
        except BaseException:
            cls._drain()
            raise

    @classmethod
    def _build_on_host(cls, scene, view_id, embedding, level, to_gray):
        with span("mvs.load_level"):
            with cls._lock:
                base = cls._levels.get((view_id, 0))
            if base is None:
                base = to_gray(cls._decode(scene, view_id, embedding))
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
            count("levels_built_on_device", 0)
            return img

    @classmethod
    def _build_on_device(cls, scene, view_id, embedding, level, to_gray, device):
        from ..ops import pyramid as pyramid_ops

        if to_gray is not _to_gray:
            raise ValueError("the CUDA level build computes _to_gray; "
                             "build other gray conversions with device='cpu'")
        with span("mvs.load_level"):
            image = cls._decode(scene, view_id, embedding)
            if image.dtype not in (np.uint8, np.uint16, np.float32):
                image = image_tools.to_float(image)
            with warnings.catch_warnings():
                # A decoded image may be read-only: the copy to the card
                # only reads it.
                warnings.filterwarnings("ignore", "The given NumPy array is not writable")
                host = torch.from_numpy(np.ascontiguousarray(image))
            img = pyramid_ops.level_image(host.to(device), level,
                                          half_size_taps(np.float32)).cpu().numpy()
            count("halvings", level)
            count("levels_built_on_device")
            with cls._lock:
                cls._levels[(view_id, level)] = img
            return img

    @classmethod
    def cleanup(cls) -> None:
        with cls._lock:
            wait(cls._pending.values())
            cls._scene = cls._embedding = None
            cls._levels, cls._pending = {}, {}
