"""The benchmark's community photo collection: one landmark photographed
by many cameras at mixed sizes, orientations, zooms and distances,
written as an MVE scene (the landmark36 configuration).

The content is harness/scene.py's two-plane scene (a background plane at
z = PLANE_Z, a textured near patch at z = NEAR_Z), its background
textured over [-extent, extent]^2 instead of [-4, 4]^2, so that every
pixel of every view sees texture. Its arithmetic (rays, hits, bilinear
texture lookups) is scene.py's frozen code, called at each view's own
size; only the background's texture coordinates take the configuration's
extent. Everything is float64; images are rendered with torch on the
run's device. Nothing here goes through the program.

The views: the configuration's camera formats, in chunks of views that
alternate between its two sets of formats (chunk_formats), so that two
consecutive chunks hold every format once; in each chunk one view is
portrait (the camera rolled 90 degrees), each format in turn. Each
camera stands in one of three distance bands (view id modulo 3) on an
arc around the landmark, looks at it, and has its own focal length
(a zoom), all drawn from the seed.
"""

from __future__ import annotations

import math
import os

import numpy as np

from mvebench.harness import scene as gen
from mvebench.harness.scene import Camera, rng_for

# Where the cameras look: the near patch's centre, half-way to the
# background plane.
TARGET = np.array([-0.6, -0.1, 0.5 * (gen.NEAR_Z + gen.PLANE_Z)])


def view_formats(cfg: dict) -> list:
    """(width, height) of each view, in view-id order. The formats scale
    with cfg["width"] against the first format's (1 at the configuration's
    own size); a portrait view swaps its format's sides."""
    fmts = cfg["formats"]
    scale = cfg["width"] / fmts[0][0]
    sets = cfg["chunk_formats"]
    per_chunk = len(sets[0])
    out = []
    for v in range(cfg["views"]):
        chunk, pos = divmod(v, per_chunk)
        group = sets[chunk % len(sets)]
        turn = chunk // len(sets)                 # how often this set came before
        f = group[pos]
        w, h = (max(2, round(x * scale)) for x in fmts[f])
        out.append((h, w) if f == group[turn % per_chunk] else (w, h))
    return out


def level_for(w: int, h: int, max_pixels: int) -> int:
    """dmrecon --max-pixels: the smallest level s with (w >> s) * (h >> s)
    <= max_pixels (MVE's dmrecon.cc; the program's rule)."""
    s = 0
    while (w >> s) * (h >> s) > max_pixels:
        s += 1
    return s


def _look_at(centre, target, roll: float) -> np.ndarray:
    """World -> camera rotation of a camera at centre looking at target,
    image x along world x and image y along world y (pointing down) when
    it looks along +z, then rolled by `roll` radians about its axis."""
    z = target - centre
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return gen.rodrigues([0.0, 0.0, roll]) @ R


def make_cameras(cfg: dict, rng: np.random.Generator) -> list:
    """One camera a view: band (view id modulo 3) and its distance from
    TARGET, azimuth and elevation on the arc, the aim's offset, roll and
    focal length, drawn in that order view by view."""
    sizes = view_formats(cfg)
    bands = cfg["distance_bands"]
    lo_f, hi_f = cfg["flen_range"]
    az, el = (math.radians(a) for a in cfg["arc_degrees"])
    cams = []
    for v, (w, h) in enumerate(sizes):
        dist = rng.uniform(*bands[v % len(bands)])
        a, e = rng.uniform(-az, az), rng.uniform(-el, el)
        aim = TARGET + np.r_[rng.uniform(-1.0, 1.0, 2) * cfg["aim_offset"], 0.0]
        roll = rng.uniform(-1.0, 1.0) * math.radians(cfg["roll_degrees"])
        flen = rng.uniform(lo_f, hi_f)
        centre = TARGET + dist * np.array([math.sin(a) * math.cos(e), math.sin(e),
                                           -math.cos(a) * math.cos(e)])
        R = _look_at(centre, aim, roll + (math.pi / 2 if h > w else 0.0))
        # The values a view's meta.ini holds: what the program reads back.
        R = R.astype(np.float32).astype(np.float64)
        t = (-R @ centre).astype(np.float32).astype(np.float64)
        cams.append(Camera(R, t, float(np.float32(flen))))
    return cams


def render_gray(textures, cam: Camera, w: int, h: int, extent: float, torch_mod,
                device) -> np.ndarray:
    """(H, W) uint8 image of the landmark seen by cam: scene.py's hits,
    the background's texture over [-extent, extent]^2."""
    t = torch_mod
    far, near_tex = (t.tensor(x, dtype=t.float64, device=device) for x in textures)
    dirs, centre = gen.pixel_rays(cam, w, h, t, device)
    _, u, v, near = gen.surface_hits(dirs, centre, t)
    tf = (gen.PLANE_Z - centre[2]) / dirs[..., 2]
    fu = ((centre[0] + tf * dirs[..., 0]) + extent) / (2 * extent)
    fv = ((centre[1] + tf * dirs[..., 1]) + extent) / (2 * extent)
    gray = t.where(near, gen._sample(near_tex, u, v, t),
                   gen._sample(far, fu.clamp(0, 1), fv.clamp(0, 1), t))
    return (gray * 255).to(t.uint8).cpu().numpy()


def background_reach(cam: Camera, w: int, h: int) -> float:
    """The largest |x| or |y| at which the rays through the image's
    corners meet the background plane (its hits span the corners' hull);
    inf where a corner's ray misses it."""
    Ki = np.linalg.inv(cam.K(w, h))
    c = cam.centre
    reach = 0.0
    for x, y in ((0, 0), (w, 0), (0, h), (w, h)):
        d = cam.R.T @ (Ki @ np.array([x, y, 1.0]))
        if d[2] <= 0:
            return math.inf
        p = c + d * (gen.PLANE_Z - c[2]) / d[2]
        reach = max(reach, abs(p[0]), abs(p[1]))
    return reach


def bundle_points(n_points: int, cams: list, sizes: list, extent: float,
                  rng: np.random.Generator):
    """n_points SfM points on the visible planes: (P, 3) positions and, for
    each, the views that see it unoccluded inside their own image. Points
    are drawn over [-extent, extent]^2 in rounds (4 n_points, then
    n_points), and the first n_points that two views or more see are
    kept."""
    x0, x1, y0, y1 = gen.NEAR_BOUNDS
    kept_pts, kept_vis, total = [], [], 0
    while total < n_points:
        size = n_points if kept_pts else 4 * n_points
        xy = rng.uniform(-extent, extent, (size, 2))
        on_near = (xy[:, 0] >= x0) & (xy[:, 0] <= x1) & (xy[:, 1] >= y0) & (xy[:, 1] <= y1)
        pts = np.c_[xy, np.where(on_near, gen.NEAR_Z, gen.PLANE_Z)]
        vis = np.stack([gen.seen_by(cam, pts, on_near, w, h) for cam, (w, h) in zip(cams, sizes)])
        keep = vis.sum(0) >= 2
        kept_pts.append(pts[keep])
        kept_vis.append(vis[:, keep])
        total += int(keep.sum())
    return np.concatenate(kept_pts)[:n_points], np.concatenate(kept_vis, axis=1)[:, :n_points]


def write_scene(scene: str, cfg: dict, seed: int, torch_mod, device,
                threads: int = gen.WRITER_THREADS) -> list:
    """Render and write the collection as an MVE scene: every view's
    meta.ini and undistorted.png (RGB, the gray value thrice) at its own
    size, and synth_0.out. PNGs are encoded by `threads` threads. Returns
    the cameras. Raises where a view would see past the textured extent."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    sizes = view_formats(cfg)
    cams = make_cameras(cfg, rng_for(seed, 0))
    extent = cfg["extent"]
    for v, (cam, (w, h)) in enumerate(zip(cams, sizes)):
        if background_reach(cam, w, h) > extent:
            raise ValueError(f"view {v} sees past the textured extent {extent}")
    textures = gen.textures_for(seed, cfg["texture_size"])

    def save(i, gray):
        Image.fromarray(np.repeat(gray[:, :, None], 3, axis=2)).save(
            os.path.join(gen.view_dir(scene, i), "undistorted.png"), compress_level=1)

    with ThreadPoolExecutor(threads) as pool:
        futures = []
        for i, (cam, (w, h)) in enumerate(zip(cams, sizes)):
            os.makedirs(gen.view_dir(scene, i), exist_ok=True)
            gen.write_meta(gen.view_dir(scene, i), i, cam)
            futures.append(pool.submit(save, i, render_gray(textures, cam, w, h, extent,
                                                            torch_mod, device)))
        for f in futures:
            f.result()
    pts, vis = bundle_points(cfg["bundle_points"], cams, sizes, extent, rng_for(seed, 3))
    gen.write_bundle(os.path.join(scene, "synth_0.out"), cams, pts, vis)
    return cams
