"""A forward-motion drive down a street canyon: the plain reference of the
kitti00 deployment (KITTI odometry, Geiger et al., CVPR 2012).

A forward-facing camera 1.65 m above a flat road, a frame every 0.8 m
along +z, with seeded jitter; two textured facades 5 m to the left and 7 m
to the right of the path, 30 m tall; a textured cross wall 50 m past the
last frame, so that every pixel's ray ends on a surface. SfM tracks a
point only from the frames within TRACK_RANGE of it, so a frame shares
bundle points with the frames at most 37 ahead or behind it, and a
stretch whose first and last 38 frames are never reconstructed gives
every reconstructed frame the neighbourhood a whole drive gives it.
Cameras follow
MVE's convention (x right, y down, z forward; x_cam = R x_world + t; the
focal length relative to the larger image side, the principal point at
the image centre, pixel centres at (x + 0.5, y + 0.5)); KITTI's
fx = 718.856 at 1241 wide gives 0.5793 (its principal point lies within
14 px of the centre).

Everything is float64: the rays, their first hit, the texture lookup
(bilinear, each texture periodic), the true ray-length depth, the
pixels that can be triangulated ("resolvable") and the SfM points with
the frames that see them. Besides numpy, scipy and torch it imports only
the texture maker and Rodrigues' formula of synthetic.py, and nothing of
the port's solvers or kernels. mvebench/harness/street.py is
its frozen copy (arithmetic identical; tests/test_torch_street.py and
mvebench/tests/test_bench_street.py hold the two together).
"""

from __future__ import annotations

import math

import numpy as np

from .synthetic import make_texture, rodrigues_to_matrix

SPACING = 0.8              # m between frames: 3.7 km over 4,541 frames
CAM_HEIGHT = 1.65          # m above the road (Geiger et al., IJRR 2013)
ROAD_Y = CAM_HEIGHT        # the road plane, y pointing down
LEFT_X, RIGHT_X = -5.0, 7.0
WALL_HEIGHT = 30.0         # facades reach y = ROAD_Y - WALL_HEIGHT
CROSS_WALL_AHEAD = 50.0    # m past the last frame
FLEN = float(np.float32(718.856 / 1241))
LATERAL_SIGMA, HEIGHT_SIGMA, YAW_SIGMA_DEG = 0.05, 0.02, 0.3
# A texel is one pixel at a frame's median depth: 12.5 m (the median ray
# length over a frame's pixels at 1241x376: 12.43-12.56 m over the
# frames and seeds measured) over the focal length in pixels, 718.856.
TEXEL = 12.5 / 718.856
TEXTURE_SIZE = 2048        # texels a period: 35.6 m
TEXTURE_SMOOTH = 3.0
# SfM tracks a point over at most a fivefold change of its image scale:
# from 6 m, where a facade 5 m to the side enters the 81.6 degree view, to
# 30 m. A frame lists a point in the bundle only within that range, as a
# real drive's turns, occluders and changing appearance end its tracks;
# a straight canyon would otherwise share its far end with every frame,
# and global view selection would draw neighbours from the whole stretch.
# Seeds reach no farther, so dmrecon's depth range ends at 1.4 x 30 m.
TRACK_RANGE = 30.0
# Resolvable: the surface point lies within TRACK_RANGE of the reference
# and is seen, unoccluded, inside the image and within TRACK_RANGE, by at
# least SEEN_BY other frames, each with a parallax of at least
# MIN_PARALLAX_DEG to the reference. SEEN_BY is MVE's nrReconNeighbors
# (4). One pixel of disparity is 1 / 718.856 rad (0.080 deg) at KITTI's
# focal length, so at 2 deg it moves the depth by about 4%, inside the
# check's 5%; below that a one-pixel match error can leave the surface.
SEEN_BY = 4
MIN_PARALLAX_DEG = 2.0

SURFACES = ("left", "right", "road", "cross")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a seed (any size of int)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


class Camera:
    """A pinhole camera in MVE's convention (see the module docstring)."""

    def __init__(self, R: np.ndarray, t: np.ndarray, flen: float = FLEN):
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)
        self.flen = float(flen)

    @property
    def centre(self) -> np.ndarray:
        return -self.R.T @ self.t

    def K(self, w: int, h: int) -> np.ndarray:
        f = self.flen * (w if w >= h else h)
        return np.array([[f, 0.0, 0.5 * w], [0.0, f, 0.5 * h], [0.0, 0.0, 1.0]])


def make_cameras(n_views: int, rng: np.random.Generator) -> list:
    """Frame i at z = SPACING i on the road's centre line, looking along
    +z, with seeded lateral, height and yaw jitter."""
    cams = []
    for i in range(n_views):
        lateral, height, yaw = rng.standard_normal(3)
        centre = np.array([lateral * LATERAL_SIGMA, height * HEIGHT_SIGMA, SPACING * i])
        R = rodrigues_to_matrix([0.0, math.radians(yaw * YAW_SIGMA_DEG), 0.0])
        # The values a view's meta.ini holds: what the program reads back.
        R = R.astype(np.float32).astype(np.float64)
        t = (-R @ centre).astype(np.float32).astype(np.float64)
        cams.append(Camera(R, t))
    return cams


def cross_wall_z(n_views: int) -> float:
    return SPACING * (n_views - 1) + CROSS_WALL_AHEAD


def texture_seed(seed: int, k: int) -> int:
    """The 32-bit seed of surface k's texture."""
    return int(rng_for(seed, 1, k).integers(1 << 32))


def textures_for(seed: int, size: int = TEXTURE_SIZE) -> list:
    """One texture per surface, in SURFACES' order: seeded periodic
    multi-octave noise, band-limited so that bilinear samples from
    slightly different positions stay correlated."""
    return [make_texture(size, seed=texture_seed(seed, k), smooth_sigma=TEXTURE_SMOOTH)
            for k in range(len(SURFACES))]


def pixel_rays(cam: Camera, w: int, h: int, torch_mod, device):
    """(H, W, 3) unit world directions through the pixel centres, and the
    camera centre, as float64 tensors."""
    t = torch_mod
    Ki = t.tensor(np.linalg.inv(cam.K(w, h)), dtype=t.float64, device=device)
    R = t.tensor(cam.R, dtype=t.float64, device=device)
    ys = t.arange(h, dtype=t.float64, device=device)[:, None].expand(h, w) + 0.5
    xs = t.arange(w, dtype=t.float64, device=device)[None, :].expand(h, w) + 0.5
    pix = t.stack([xs, ys, t.ones_like(xs)], dim=-1)
    dirs = (pix @ Ki.T) @ R
    dirs = dirs / t.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs, t.tensor(cam.centre, dtype=t.float64, device=device)


def first_hit(origin, dirs, wall_z: float, torch_mod):
    """The first surface along each ray: (length, surface index into
    SURFACES). origin: (3,) or broadcastable to dirs (..., 3)."""
    t = torch_mod
    inf = t.full_like(dirs[..., 0], math.inf)
    ox, oy, oz = origin[..., 0], origin[..., 1], origin[..., 2]
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    top = ROAD_Y - WALL_HEIGHT

    def facade(x, side):
        s = (x - ox) / dx
        ok = (side * dx > 0) & (oy + s * dy >= top)
        return t.where(ok, s, inf)

    road = t.where(dy > 0, (ROAD_Y - oy) / dy, inf)
    cross = t.where(dz > 0, (wall_z - oz) / dz, inf)
    lengths = t.stack([facade(LEFT_X, -1.0), facade(RIGHT_X, 1.0), road, cross])
    return lengths.min(dim=0)


def _sample(tex, a, b, torch_mod):
    """Bilinear lookup of a periodic texture at surface coordinates (a, b)
    in metres: a along the texture's columns, b along its rows."""
    t = torch_mod
    n = tex.shape[0]
    x, y = a / TEXEL, b / TEXEL
    x0, y0 = t.floor(x), t.floor(y)
    fx, fy = x - x0, y - y0
    i0 = t.remainder(x0, n).long()
    j0 = t.remainder(y0, n).long()
    i1, j1 = (i0 + 1) % n, (j0 + 1) % n
    return (tex[j0, i0] * (1 - fx) * (1 - fy) + tex[j0, i1] * fx * (1 - fy)
            + tex[j1, i0] * (1 - fx) * fy + tex[j1, i1] * fx * fy)


def render_gray(textures, cam: Camera, w: int, h: int, wall_z: float,
                torch_mod, device) -> np.ndarray:
    """(H, W) uint8 image of the street seen by cam."""
    t = torch_mod
    dirs, centre = pixel_rays(cam, w, h, t, device)
    length, surface = first_hit(centre, dirs, wall_z, t)
    p = centre + dirs * length[..., None]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    coords = ((z, y), (z, y), (x, z), (x, y))      # per surface, SURFACES' order
    gray = t.zeros_like(length)
    for k, (tex, (a, b)) in enumerate(zip(textures, coords)):
        gray = t.where(surface == k, _sample(t.tensor(tex, dtype=t.float64, device=device),
                                             a, b, t), gray)
    return (gray * 255).to(t.uint8).cpu().numpy()


def truth_depth(cam: Camera, w: int, h: int, wall_z: float, torch_mod, device) -> np.ndarray:
    """(H, W) float64 ray-length depth of the visible surface."""
    dirs, centre = pixel_rays(cam, w, h, torch_mod, device)
    return first_hit(centre, dirs, wall_z, torch_mod)[0].cpu().numpy()


def sees(cam: Camera, pts, w: int, h: int, wall_z: float, torch_mod):
    """Which of the points (float64 tensor (N, 3), on the surfaces) cam
    sees: in front of it, inside its (w, h) image, within TRACK_RANGE, and
    the first surface along its ray to the point."""
    t = torch_mod
    dev = pts.device
    R = t.tensor(cam.R, dtype=t.float64, device=dev)
    pc = pts @ R.T + t.tensor(cam.t, dtype=t.float64, device=dev)
    proj = pc @ t.tensor(cam.K(w, h), dtype=t.float64, device=dev).T
    u, v = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
    inside = (pc[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    centre = t.tensor(cam.centre, dtype=t.float64, device=dev)
    d = pts - centre
    dist = t.linalg.norm(d, dim=-1)
    length, _ = first_hit(centre, d / dist[:, None], wall_z, t)
    return inside & (dist <= TRACK_RANGE) & (length >= dist * (1 - 1e-9))


def resolvable(cams: list, v: int, w: int, h: int, torch_mod, device) -> np.ndarray:
    """(H, W) bool: the pixels of view v whose surface point lies within
    TRACK_RANGE and at least SEEN_BY other frames see with a parallax of
    at least MIN_PARALLAX_DEG (see the module's constants)."""
    t = torch_mod
    wall_z = cross_wall_z(len(cams))
    dirs, centre = pixel_rays(cams[v], w, h, t, device)
    length, _ = first_hit(centre, dirs, wall_z, t)
    pts = (centre + dirs * length[..., None]).reshape(-1, 3)
    to_ref = -dirs.reshape(-1, 3)
    cos_min = math.cos(math.radians(MIN_PARALLAX_DEG))
    count = t.zeros(pts.shape[0], dtype=t.int64, device=device)
    for j in range(len(cams)):
        if j == v:
            continue
        to_j = t.tensor(cams[j].centre, dtype=t.float64, device=device) - pts
        cos = (to_j * to_ref).sum(-1) / t.linalg.norm(to_j, dim=-1)
        count += (sees(cams[j], pts, w, h, wall_z, t) & (cos <= cos_min)).long()
    near = (length <= TRACK_RANGE).reshape(-1)
    return (near & (count >= SEEN_BY)).reshape(h, w).cpu().numpy()


def bundle_points(n_points: int, cams: list, w: int, h: int, rng: np.random.Generator,
                  torch_mod, device="cpu"):
    """n_points SfM points on the visible surfaces: (P, 3) positions and,
    for each, the frames that see it. Points are the first hits of rays
    through uniform positions of uniformly drawn frames, drawn in rounds
    (2 n_points, then n_points); the first n_points that two frames or
    more see (within TRACK_RANGE) are kept."""
    t = torch_mod
    wall_z = cross_wall_z(len(cams))
    kept_pts, kept_vis, total = [], [], 0
    while total < n_points:
        size = n_points if kept_pts else 2 * n_points
        frame = rng.integers(len(cams), size=size)
        xy = rng.uniform([0.0, 0.0], [w, h], (size, 2))
        pts = np.empty((size, 3))
        for j in np.unique(frame):
            cam = cams[j]
            sel = frame == j
            pix = np.c_[xy[sel], np.ones(sel.sum())]
            dirs = (pix @ np.linalg.inv(cam.K(w, h)).T) @ cam.R
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            d = t.tensor(dirs, dtype=t.float64, device=device)
            c = t.tensor(cam.centre, dtype=t.float64, device=device)
            length, _ = first_hit(c, d, wall_z, t)
            pts[sel] = cam.centre + dirs * length.cpu().numpy()[:, None]
        p = t.tensor(pts, dtype=t.float64, device=device)
        vis = np.stack([sees(cam, p, w, h, wall_z, t).cpu().numpy() for cam in cams])
        keep = vis.sum(0) >= 2
        kept_pts.append(pts[keep])
        kept_vis.append(vis[:, keep])
        total += int(keep.sum())
    return np.concatenate(kept_pts)[:n_points], np.concatenate(kept_vis, axis=1)[:, :n_points]
