"""The benchmark's own inputs: two-plane scenes, written in MVE's formats.

The arithmetic of the two-plane scene (texture, ring of cameras, ray and
plane intersection, bilinear texture lookup) is a frozen copy of the
generator in mve_tpu_torch/synthetic.py, so that a change to the program
cannot change the yardstick. Images are rendered on the device with
torch; everything that must repeat bit for bit from a seed (texture,
cameras, bundle, depth noise, point sets) is drawn on the host from
numpy's SeedSequence, which takes seeds of any size.

Writers: an MVE scene (views/view_NNNN.mve/meta.ini, undistorted.png,
synth_0.out) and FSSR point sets (binary PLY with normals, colour,
confidence and the scale in "value"), as makescene, sfmrecon and
scene2pset -F2 would leave them. Nothing here goes through the program.
"""

from __future__ import annotations

import math
import os

import numpy as np

PLANE_Z = 5.0
PLANE_EXTENT = 4.0  # the background plane spans [-E, E]^2 at z = PLANE_Z
NEAR_Z = 3.5
NEAR_BOUNDS = (-1.6, 0.4, -1.2, 1.0)  # x0, x1, y0, y1 of the near patch
RING_SPREAD = 0.55
FLEN = 0.9  # MVE's focal length, relative to the larger image side
TEXTURE_SIZE = 512
TEXTURE_SMOOTH = 3.0
WRITER_THREADS = 4  # PNG encoding and numpy release the GIL: set-up about 3x faster on 4


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a seed (any size of int)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


def rodrigues(r) -> np.ndarray:
    r = np.asarray(r, np.float64)
    a2 = float(r @ r)
    a = math.sqrt(max(a2, 1e-32))
    small = a2 < 1e-12
    sinc = 1.0 - a2 / 6.0 if small else math.sin(a) / a
    cosc = 0.5 - a2 / 24.0 if small else (1.0 - math.cos(a)) / max(a2, 1e-32)
    K = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]])
    return np.eye(3) + sinc * K + cosc * (K @ K)


def make_texture(rng: np.random.Generator, size=TEXTURE_SIZE, octaves=4,
                 smooth_sigma=TEXTURE_SMOOTH) -> np.ndarray:
    """Multi-scale random texture in [0, 1], band-limited so that bilinear
    samples from slightly different positions stay correlated."""
    from scipy.ndimage import gaussian_filter

    tex = np.zeros((size, size), np.float64)
    for o in range(octaves):
        n = size >> (octaves - 1 - o)
        layer = rng.random((n, n))
        rep = size // n
        tex += np.repeat(np.repeat(layer, rep, 0), rep, 1) / (2 ** (octaves - 1 - o))
    tex = gaussian_filter(tex, smooth_sigma, mode="wrap")
    tex -= tex.min()
    tex /= max(tex.max(), 1e-9)
    return tex


class Camera:
    """A pinhole camera in MVE's convention: x_cam = R x_world + t, the
    focal length relative to the larger image side, the principal point
    at the image centre, pixel centres at (x + 0.5, y + 0.5)."""

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


def make_cameras(n_views: int, rng: np.random.Generator, spread=RING_SPREAD) -> list:
    """View 0 at the origin looking along +z, the others on a ring around
    it, each with a small seeded offset in z and roll."""
    cams = []
    for i in range(n_views):
        if i == 0:
            centre, R = np.zeros(3), np.eye(3)
        else:
            angle = 2 * np.pi * (i - 1) / max(n_views - 1, 1)
            centre = np.array([np.cos(angle), np.sin(angle), 0.0]) * spread
            centre[2] += rng.standard_normal() * 0.02
            R = rodrigues([0.0, 0.0, rng.standard_normal() * 0.01])
        # The values a view's meta.ini holds: what the program reads back.
        R = R.astype(np.float32).astype(np.float64)
        t = (-R @ centre).astype(np.float32).astype(np.float64)
        cams.append(Camera(R, t))
    return cams


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


def surface_hits(dirs, centre, torch_mod):
    """Ray length to the visible surface and the texture coordinates there:
    (depth, u, v, near) with near True where the near patch is hit."""
    t = torch_mod

    def hit(z):
        tt = (z - centre[2]) / dirs[..., 2]
        return tt, centre[0] + tt * dirs[..., 0], centre[1] + tt * dirs[..., 1]

    tf, fx, fy = hit(PLANE_Z)
    tn, nx, ny = hit(NEAR_Z)
    x0, x1, y0, y1 = NEAR_BOUNDS
    near = (nx >= x0) & (nx <= x1) & (ny >= y0) & (ny <= y1)
    u = t.where(near, (nx - x0) / (x1 - x0), (fx + PLANE_EXTENT) / (2 * PLANE_EXTENT))
    v = t.where(near, (ny - y0) / (y1 - y0), (fy + PLANE_EXTENT) / (2 * PLANE_EXTENT))
    return t.where(near, tn, tf), u.clamp(0, 1), v.clamp(0, 1), near


def _sample(tex, u, v, torch_mod):
    t = torch_mod
    H, W = tex.shape
    x = (u * (W - 1)).clamp(0, W - 1.001)
    y = (v * (H - 1)).clamp(0, H - 1.001)
    x0 = t.floor(x).long()
    y0 = t.floor(y).long()
    fx, fy = x - x0, y - y0
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)


def render_gray(textures, cam: Camera, w: int, h: int, torch_mod, device) -> np.ndarray:
    """(H, W) uint8 image of the two planes seen by cam."""
    t = torch_mod
    far, near_tex = (t.tensor(x, dtype=t.float64, device=device) for x in textures)
    dirs, centre = pixel_rays(cam, w, h, t, device)
    _, u, v, near = surface_hits(dirs, centre, t)
    gray = t.where(near, _sample(near_tex, u, v, t), _sample(far, u, v, t))
    return (gray * 255).to(t.uint8).cpu().numpy()


def truth_depth(cam: Camera, w: int, h: int, torch_mod, device) -> np.ndarray:
    """(H, W) float64 ray-length depth of the visible surface."""
    dirs, centre = pixel_rays(cam, w, h, torch_mod, device)
    return surface_hits(dirs, centre, torch_mod)[0].cpu().numpy()


def level_dims(w: int, h: int, level: int):
    """Image size at pyramid level `level` (MVE halves, rounding up)."""
    for _ in range(level):
        w, h = (w + 1) >> 1, (h + 1) >> 1
    return w, h


# --------------------------------------------------------------------------
# the scene on disk
# --------------------------------------------------------------------------

def _fmt(x: float) -> str:
    return f"{x:.10g}"


def write_meta(view_dir: str, view_id: int, cam: Camera) -> None:
    lines = ["[camera]",
             f"focal_length = {_fmt(cam.flen)}",
             "pixel_aspect = 1",
             "principal_point = 0.5 0.5",
             "radial_distortion = 0 0",
             "rotation = " + " ".join(_fmt(x) for x in cam.R.reshape(-1)),
             "translation = " + " ".join(_fmt(x) for x in cam.t),
             "",
             "[view]",
             f"id = {view_id}",
             f"name = view_{view_id:04d}"]
    with open(os.path.join(view_dir, "meta.ini"), "w") as f:
        f.write("\n".join(lines) + "\n")


def view_dir(scene: str, view_id: int) -> str:
    return os.path.join(scene, "views", f"view_{view_id:04d}.mve")


def seen_by(cam: Camera, pts: np.ndarray, on_near: np.ndarray, w: int, h: int) -> np.ndarray:
    """Which of the points (on the planes; on_near marks those on the near
    patch) cam sees: in front of it, inside its (w, h) image, and, for a
    background point, not behind the near patch."""
    x0, x1, y0, y1 = NEAR_BOUNDS
    pc = pts @ cam.R.T + cam.t
    proj = pc @ cam.K(w, h).T
    with np.errstate(divide="ignore", invalid="ignore"):
        u, v = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
    inside = (pc[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    c = cam.centre
    s = (NEAR_Z - c[2]) / (pts[:, 2] - c[2])
    cx, cy = c[0] + s * (pts[:, 0] - c[0]), c[1] + s * (pts[:, 1] - c[1])
    hidden = ~on_near & (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)
    return inside & ~hidden


def bundle_points(n_points: int, cams: list, w: int, h: int,
                  rng: np.random.Generator):
    """n_points SfM points on the visible planes: (P, 3) positions and, for
    each, the views that see it unoccluded inside the image. Points are
    drawn in rounds (2 n_points, then n_points), and the first n_points
    that two views or more see are kept."""
    x0, x1, y0, y1 = NEAR_BOUNDS
    # The region the ring of cameras sees on the background plane.
    half_w = PLANE_Z * 0.5 / FLEN + RING_SPREAD
    half_h = half_w * min(w, h) / max(w, h) + RING_SPREAD
    kept_pts, kept_vis, total = [], [], 0
    while total < n_points:
        size = n_points if kept_pts else 2 * n_points
        xy = rng.uniform([-half_w, -half_h], [half_w, half_h], (size, 2))
        on_near = (xy[:, 0] >= x0) & (xy[:, 0] <= x1) & (xy[:, 1] >= y0) & (xy[:, 1] <= y1)
        pts = np.c_[xy, np.where(on_near, NEAR_Z, PLANE_Z)]
        vis = np.stack([seen_by(cam, pts, on_near, w, h) for cam in cams])
        keep = vis.sum(0) >= 2
        kept_pts.append(pts[keep])
        kept_vis.append(vis[:, keep])
        total += int(keep.sum())
    return np.concatenate(kept_pts)[:n_points], np.concatenate(kept_vis, axis=1)[:, :n_points]


def write_bundle(path: str, cams: list, pts: np.ndarray, vis: np.ndarray) -> None:
    """synth_0.out in MVE's format ("drews 1.0"): cameras, then each point
    with its colour and the (view, feature, quality) of every view that
    sees it."""
    lines = ["drews 1.0", f"{len(cams)} {len(pts)}"]
    for cam in cams:
        r = cam.R.reshape(-1)
        lines += [f"{_fmt(cam.flen)} 0 0", " ".join(_fmt(x) for x in r[:3]),
                  " ".join(_fmt(x) for x in r[3:6]), " ".join(_fmt(x) for x in r[6:]),
                  " ".join(_fmt(x) for x in cam.t)]
    feat_ids = np.cumsum(vis, axis=1) - 1
    for p in range(len(pts)):
        views = np.nonzero(vis[:, p])[0]
        refs = " ".join(f"{v} {feat_ids[v, p]} 0" for v in views)
        lines += [" ".join(_fmt(x) for x in pts[p]), "128 128 128", f"{len(views)} {refs}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def textures_for(seed: int, size: int = TEXTURE_SIZE):
    """The far plane's and the near patch's textures. A configuration
    whose level-2 image has more pixels across the planes gives a larger
    size, so that a texel spans about one level-2 pixel in every one."""
    return make_texture(rng_for(seed, 1), size), make_texture(rng_for(seed, 2), size)


def write_scene(scene: str, cfg: dict, seed: int, torch_mod, device,
                threads: int = WRITER_THREADS) -> list:
    """Render and write a whole MVE scene for a configuration: every
    view's meta.ini and undistorted.png (RGB, the gray value thrice) and
    synth_0.out. PNGs are encoded by `threads` threads. Returns the
    cameras."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    n, w, h = cfg["views"], cfg["width"], cfg["height"]
    cams = make_cameras(n, rng_for(seed, 0))
    textures = textures_for(seed, cfg.get("texture_size", TEXTURE_SIZE))

    def save(i, gray):
        Image.fromarray(np.repeat(gray[:, :, None], 3, axis=2)).save(
            os.path.join(view_dir(scene, i), "undistorted.png"), compress_level=1)

    with ThreadPoolExecutor(threads) as pool:
        futures = []
        for i, cam in enumerate(cams):
            os.makedirs(view_dir(scene, i), exist_ok=True)
            write_meta(view_dir(scene, i), i, cam)
            futures.append(pool.submit(save, i, render_gray(textures, cam, w, h, torch_mod, device)))
        for f in futures:
            f.result()
    pts, vis = bundle_points(cfg["bundle_points"], cams, w, h, rng_for(seed, 3))
    write_bundle(os.path.join(scene, "synth_0.out"), cams, pts, vis)
    return cams


# --------------------------------------------------------------------------
# point sets (scene2pset -F2's arithmetic on a noisy true depth map)
# --------------------------------------------------------------------------

def point_set(cam: Camera, textures, w: int, h: int, noise: float, dd_factor: float,
              scale_factor: float, conf_rings: int, rng: np.random.Generator,
              torch_mod, device) -> dict:
    """FSSR samples of one view: the true depth map at (w, h) with seeded
    relative noise, triangulated on the pixel grid as MVE's
    depthmap_triangulate does (each 2x2 block split along its diagonal
    of smaller depth difference; a triangle whose edge spans more than
    dd_factor pixel footprints, x sqrt(2) on the diagonal, is dropped),
    then angle-weighted vertex normals, the scale (mean length of the
    triangle edges at a vertex, x scale_factor) and a confidence ramp
    from 0 at the mesh border to 1 over conf_rings rings (the 8-neighbour
    distance on the grid). Returns float32 arrays pos, normal, color
    (uint8), conf, scale of the vertices in use."""
    t = torch_mod
    dirs, centre = pixel_rays(cam, w, h, t, device)
    depth, u, v, near = surface_hits(dirs, centre, t)
    far_tex, near_tex = (t.tensor(x, dtype=t.float64, device=device) for x in textures)
    gray = t.where(near, _sample(near_tex, u, v, t), _sample(far_tex, u, v, t))
    dirs, depth, centre = dirs.cpu().numpy(), depth.cpu().numpy(), centre.cpu().numpy()
    gray = (gray * 255).to(t.uint8).cpu().numpy()
    depth = depth * (1.0 + noise * rng.standard_normal(depth.shape))
    pos = centre + depth[..., None] * dirs                            # (H, W, 3)
    # Pixel footprint: the camera-z depth over the focal length in pixels.
    footprint = depth * (dirs @ cam.R[2]) / (cam.flen * max(w, h))

    idx = np.arange(h * w).reshape(h, w)
    c = [idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]]      # 0 1 / 2 3
    d = depth.reshape(-1)
    fp = footprint.reshape(-1)

    def edge_ok(a, b, diag):
        lo = np.where(d[a] <= d[b], fp[a], fp[b])
        return np.abs(d[a] - d[b]) <= lo * dd_factor * (math.sqrt(2.0) if diag else 1.0)

    split03 = np.abs(d[c[0]] - d[c[3]]) < np.abs(d[c[1]] - d[c[2]])
    tris, per_block = [], np.zeros((h - 1, w - 1), np.int64)
    for (a, b, cc), on in (((0, 3, 1), split03), ((0, 2, 3), split03),
                           ((0, 2, 1), ~split03), ((1, 2, 3), ~split03)):
        A, B, C = c[a], c[b], c[cc]
        ok = on & edge_ok(A, B, a + b == 3) & edge_ok(B, C, b + cc == 3) & edge_ok(C, A, cc + a == 3)
        tris.append(np.stack([A[ok], B[ok], C[ok]], axis=1))
        per_block += ok
    faces = np.concatenate(tris)
    P = pos.reshape(-1, 3)
    n = h * w

    # Angle-weighted vertex normals (mesh.cc recalc_normals).
    fn = np.cross(P[faces[:, 1]] - P[faces[:, 0]], P[faces[:, 2]] - P[faces[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-32)
    vn = np.zeros((n, 3))
    for k, (a, b) in enumerate(((1, 2), (2, 0), (0, 1))):
        e1 = P[faces[:, a]] - P[faces[:, k]]
        e2 = P[faces[:, b]] - P[faces[:, k]]
        cos = np.sum(e1 * e2, 1) / np.maximum(np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-32)
        wgt = fn * np.arccos(np.clip(cos, -1, 1))[:, None]
        for j in range(3):
            vn[:, j] += np.bincount(faces[:, k], weights=wgt[:, j], minlength=n)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-32)
    # The normals face the camera, as MVE's depth-map triangles do.
    flip = np.sum(vn * (P - centre), axis=1) > 0
    vn[flip] *= -1

    # Scale: mean adjacent edge length x scale_factor (scene2pset.cc:345-358).
    acc = np.zeros(n)
    deg = np.zeros(n)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        e = np.linalg.norm(P[faces[:, a]] - P[faces[:, b]], axis=1)
        acc += np.bincount(faces[:, a], weights=e, minlength=n)
        acc += np.bincount(faces[:, b], weights=e, minlength=n)
        deg += np.bincount(faces[:, a], minlength=n) + np.bincount(faces[:, b], minlength=n)
    used = deg > 0
    scale = acc / np.maximum(deg, 1) * scale_factor

    # Confidence ramp: a vertex is on the border where one of the four
    # grid blocks around it (or the image's edge) lacks a triangle.
    full = np.zeros((h + 1, w + 1), bool)
    full[1:-1, 1:-1] = per_block == 2
    inner = full[:-1, :-1] & full[:-1, 1:] & full[1:, :-1] & full[1:, 1:]
    used2 = used.reshape(h, w)
    ring = np.full((h, w), conf_rings, np.int64)
    front = used2 & ~inner
    for r in range(conf_rings):
        ring[front] = r
        grown = front.copy()
        grown[1:] |= front[:-1]
        grown[:-1] |= front[1:]
        grown[:, 1:] |= grown[:, :-1].copy()
        grown[:, :-1] |= grown[:, 1:].copy()
        front = grown & (ring == conf_rings) & used2
    conf = (ring / conf_rings).reshape(-1)

    return dict(pos=P[used].astype(np.float32), normal=vn[used].astype(np.float32),
                color=gray.reshape(-1)[used], conf=conf[used].astype(np.float32),
                scale=scale[used].astype(np.float32))


def write_point_set(path: str, ps: dict) -> None:
    """Binary PLY in the layout scene2pset writes: x y z, nx ny nz, red
    green blue (uchar), confidence, value (the scale)."""
    n = len(ps["pos"])
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("nx", "<f4"), ("ny", "<f4"),
                      ("nz", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                      ("confidence", "<f4"), ("value", "<f4")])
    rows = np.empty(n, dtype)
    for k, name in enumerate("xyz"):
        rows[name] = ps["pos"][:, k]
        rows["n" + name] = ps["normal"][:, k]
    for name in ("red", "green", "blue"):
        rows[name] = ps["color"]
    rows["confidence"] = ps["conf"]
    rows["value"] = ps["scale"]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {'uchar' if dtype[name] == np.uint8 else 'float'} {name}"
               for name in dtype.names]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rows.tobytes())


def read_ply(path: str):
    """(vertex record array, number of faces) of a binary little-endian
    PLY whose vertex element holds scalar properties only."""
    types = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
             "int": "<i4", "int32": "<i4", "uint": "<u4", "char": "i1", "short": "<i2",
             "ushort": "<u2"}
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n_vert = n_face = 0
    props, element = [], None
    for line in data[:end].decode("ascii").splitlines():
        parts = line.split()
        if parts[:1] == ["format"] and parts[1] != "binary_little_endian":
            raise IOError(f"{path}: not binary little-endian")
        if parts[:1] == ["element"]:
            element = parts[1]
            if element == "vertex":
                n_vert = int(parts[2])
            elif element == "face":
                n_face = int(parts[2])
        elif parts[:1] == ["property"] and element == "vertex":
            props.append((parts[2], types[parts[1]]))
    verts = np.frombuffer(data, np.dtype(props), count=n_vert, offset=end)
    return verts, n_face
