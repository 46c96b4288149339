"""Per-view feature detection (reference: libs/sfm/bundler_features.cc).

For each view: take the colour image, half-size it until it is at or
below max_pixels (bundler_features.cc:40-43), run SIFT and SURF,
normalise positions to centre (0,0) with larger dim 1, and record colours
at the feature locations. SIFT and SURF run batched over same-shape views
on the chosen device (compute_batched, sfmrecon's path), or one view at a
time (compute_viewport, featurerecon's path, which keeps mve_tpu's
per-view rounding of the half-sized image).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ... import resolve_device
from ...core import image_tools
from .. import sift, surf
from .common import Viewport, normalize_feature_positions


@dataclasses.dataclass
class FeaturesOptions:
    max_image_size: int = 6_000_000  # pixels (sfmrecon.cc:48)
    sift_options: sift.SiftOptions = dataclasses.field(default_factory=sift.SiftOptions)
    # SIFT+SURF is the reference default (sfmrecon.cc:96 FEATURE_ALL).
    use_surf: bool = True
    verbose: bool = False


class Features:
    def __init__(self, options: Optional[FeaturesOptions] = None, device="cuda"):
        self.opts = options or FeaturesOptions()
        self.device = resolve_device(device)

    def _limit_size(self, img: np.ndarray) -> np.ndarray:
        """Iterative half-size until <= max_image_size pixels."""
        while img.shape[0] * img.shape[1] > self.opts.max_image_size:
            imgf = torch.from_numpy(image_tools.to_float(img)).to(self.device)
            img2 = image_tools.rescale_half_size(imgf).cpu().numpy()
            img = image_tools.to_byte(img2) if img.dtype == np.uint8 else img2
        return img

    def compute_viewport(self, image: np.ndarray, viewport: Viewport) -> None:
        """Fill one viewport's features from one (H, W, C) image.

        The half-sizing rounds as mve_tpu's per-view path does,
        (img * 255.0 + 0.5).astype(np.uint8) with no clip, where
        compute_batched clips (to_byte)."""
        img = image
        while img.shape[0] * img.shape[1] > self.opts.max_image_size:
            imgf = torch.from_numpy(image_tools.to_float(img)).to(self.device)
            img = image_tools.rescale_half_size(imgf).cpu().numpy()
            img = (img * 255.0 + 0.5).astype(np.uint8) if image.dtype == np.uint8 else img
        result = sift.detect_and_describe(img, self.opts.sift_options, self.device)
        sresult = surf.detect_and_describe(img, device=self.device) if self.opts.use_surf else None
        _fill_viewport(viewport, img, result, sresult)

    def compute(self, images: List[np.ndarray], viewports: List[Viewport]) -> None:
        """One view at a time."""
        for i, (img, vp) in enumerate(zip(images, viewports)):
            self.compute_viewport(img, vp)
            if self.opts.verbose:
                print(f"View {i}: {len(vp.positions)} features")

    def compute_batched(self, images: List[np.ndarray],
                        viewports: List[Viewport]) -> None:
        """SIFT and SURF batched across same-shape views."""
        prepped = [self._limit_size(img) for img in images]
        results = sift.detect_and_describe_batch(
            prepped, self.opts.sift_options, self.device)
        if self.opts.use_surf:
            surf_results = surf.detect_and_describe_batch(prepped, device=self.device)
        else:
            surf_results = [None] * len(prepped)
        for i, (img, vp, result, sresult) in enumerate(
                zip(prepped, viewports, results, surf_results)):
            _fill_viewport(vp, img, result, sresult)
            if self.opts.verbose:
                print(f"View {i}: {len(vp.positions)} features")


def _fill_viewport(vp: Viewport, img: np.ndarray, result, sresult) -> None:
    """A viewport's size, descriptors, normalised positions and colours
    from the SIFT (and SURF, or None) result on img."""
    h, w = img.shape[:2]
    vp.width, vp.height = w, h
    xs, ys = result.x, result.y
    vp.descriptors = result.descriptors
    vp.num_sift = len(result.x)
    if sresult is not None:
        vp.surf_descriptors = sresult.descriptors
        xs = np.concatenate([xs, sresult.x])
        ys = np.concatenate([ys, sresult.y])
    vp.positions = normalize_feature_positions(np.stack([xs, ys], axis=1), w, h)
    vp.track_ids = np.full(len(xs), -1, np.int32)
    xi = np.clip(np.round(xs).astype(int), 0, w - 1)
    yi = np.clip(np.round(ys).astype(int), 0, h - 1)
    if img.ndim == 3 and img.shape[2] >= 3:
        colors = img[yi, xi, :3]
    else:
        gray = img[yi, xi] if img.ndim == 2 else img[yi, xi, 0]
        colors = np.stack([gray] * 3, axis=1)
    if colors.dtype != np.uint8:
        colors = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
    vp.colors = colors
