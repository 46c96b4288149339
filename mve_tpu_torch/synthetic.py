"""Synthetic two-plane scenes for tests and the chip smoke run.

A copy of the generator in the repository's tests/synthetic.py
(make_texture, make_cameras, render_two_plane_view,
make_two_plane_scene), written against this package's own Scene, View
and CameraInfo so that nothing here imports mve_tpu. Given the same
arguments it renders byte-identical images.

Each view renders a textured background plane z=PLANE_Z plus a nearer
textured patch at z=NEAR_Z (exact ray/plane intersection, bilinear
texture lookup); the scene directory holds ORIGINAL images only, as
makescene would create it. make_photo_folder writes the same views as a
folder of photos (PNG, and JPEG with an EXIF focal length), makescene's
input.
"""

from __future__ import annotations

import numpy as np

from .core import CameraInfo, Scene, View

PLANE_Z = 5.0
PLANE_EXTENT = 4.0  # plane spans [-E, E]^2 at z = PLANE_Z
NEAR_Z = 3.5
NEAR_BOUNDS = (-1.6, 0.4, -1.2, 1.0)  # x0, x1, y0, y1 of the near patch


def rodrigues_to_matrix(r) -> np.ndarray:
    """Axis-angle 3-vector -> 3x3 rotation matrix (numpy, float64)."""
    r = np.asarray(r, np.float64)
    a2 = float(r @ r)
    a = np.sqrt(max(a2, 1e-32))
    small = a2 < 1e-12
    sinc = 1.0 - a2 / 6.0 if small else np.sin(a) / a
    cosc = 0.5 - a2 / 24.0 if small else (1.0 - np.cos(a)) / max(a2, 1e-32)
    K = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]])
    return np.eye(3) + sinc * K + cosc * (K @ K)


def make_texture(size=512, seed=0, octaves=4, smooth_sigma=4.0):
    """Multi-scale random texture, band-limited so that bilinear samples
    from slightly different positions stay correlated."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    tex = np.zeros((size, size), np.float64)
    for o in range(octaves):
        n = size >> (octaves - 1 - o)
        layer = rng.rand(n, n)
        rep = size // n
        layer = np.repeat(np.repeat(layer, rep, 0), rep, 1)
        tex += layer / (2 ** (octaves - 1 - o))
    tex = gaussian_filter(tex, smooth_sigma, mode="wrap")
    tex -= tex.min()
    tex /= max(tex.max(), 1e-9)
    return tex


def _sample_texture(tex, u, v):
    """Bilinear sample; u, v in [0, 1]."""
    H, W = tex.shape
    x = np.clip(u * (W - 1), 0, W - 1.001)
    y = np.clip(v * (H - 1), 0, H - 1.001)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = x - x0
    fy = y - y0
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)


def make_cameras(n_views=5, flen=0.9, spread=0.45, seed=0):
    """Reference camera at origin looking +z, neighbours on a circle."""
    cams = []
    rng = np.random.RandomState(seed)
    for i in range(n_views):
        if i == 0:
            center = np.zeros(3)
            R = np.eye(3)
        else:
            angle = 2 * np.pi * (i - 1) / max(n_views - 1, 1)
            center = np.array([np.cos(angle), np.sin(angle), 0.0]) * spread
            center[2] += rng.randn() * 0.02
            R = rodrigues_to_matrix([0.0, 0.0, rng.randn() * 0.01])
        cam = CameraInfo(flen=flen)
        cam.rot = R.astype(np.float32)
        cam.trans = (-R @ center).astype(np.float32)
        cams.append(cam)
    return cams


def render_two_plane_view(tex_far, tex_near, cam: CameraInfo,
                          width: int, height: int) -> np.ndarray:
    """Render the background plane plus the near patch; (H, W, 3) uint8."""
    Ki = cam.inverse_calibration(width, height)
    R = cam.rot.astype(np.float64)
    t = cam.trans.astype(np.float64)
    center = -R.T @ t
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1)
    dirs_world = (pix @ Ki.T) @ R

    def hit(z_plane):
        tt = (z_plane - center[2]) / dirs_world[..., 2]
        return center[0] + tt * dirs_world[..., 0], center[1] + tt * dirs_world[..., 1]

    fx, fy = hit(PLANE_Z)
    u = (fx + PLANE_EXTENT) / (2 * PLANE_EXTENT)
    v = (fy + PLANE_EXTENT) / (2 * PLANE_EXTENT)
    gray = _sample_texture(tex_far, np.clip(u, 0, 1), np.clip(v, 0, 1))

    nx, ny = hit(NEAR_Z)
    x0, x1, y0, y1 = NEAR_BOUNDS
    near_mask = (nx >= x0) & (nx <= x1) & (ny >= y0) & (ny <= y1)
    nu = (nx - x0) / (x1 - x0)
    nv = (ny - y0) / (y1 - y0)
    near_gray = _sample_texture(tex_near, np.clip(nu, 0, 1), np.clip(nv, 0, 1))
    gray = np.where(near_mask, near_gray, gray)
    img = (gray * 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def make_two_plane_scene(path: str, n_views=6, width=240, height=180, seed=0,
                         with_cameras=True):
    """Write a scene of ORIGINAL images; returns (scene, ground-truth cams)."""
    tex_far = make_texture(seed=seed, smooth_sigma=3.0)
    tex_near = make_texture(seed=seed + 100, smooth_sigma=3.0)
    cams = make_cameras(n_views, spread=0.55, seed=seed)
    scene = Scene.create(path)
    for i, cam in enumerate(cams):
        view = View.create(scene.view_dir_for_id(i), i)
        view.set_original_image(render_two_plane_view(tex_far, tex_near, cam, width, height))
        if with_cameras:
            view.set_camera(cam)
        view.save_view()
        scene.add_view(view)
    scene.save_views()
    return scene, cams


def save_photo(img: np.ndarray, path: str, focal_mm=None) -> None:
    """Write an (H, W, 3) uint8 image as a photo: a PNG, or with focal_mm a
    JPEG (quality 95) whose EXIF names a camera maker and model and
    carries focal_mm as the focal length and its 35 mm equivalent."""
    from PIL import Image
    from PIL.TiffImagePlugin import IFDRational

    pil = Image.fromarray(img)
    if focal_mm is None:
        pil.save(path)
        return
    exif = Image.Exif()
    exif[0x010F] = "Canon"           # Make
    exif[0x0110] = "Canon EOS 5D"    # Model
    sub = exif.get_ifd(0x8769)       # the Exif IFD
    sub[0x920A] = IFDRational(int(focal_mm), 1)   # FocalLength
    sub[0xA405] = int(focal_mm)      # FocalLengthIn35mmFilm
    pil.save(path, quality=95, exif=exif.tobytes())


def make_photo_folder(path: str, n_views=4, width=240, height=180, seed=0,
                      jpeg_every=2, focal_mm=35.0):
    """Write the views of make_two_plane_scene as image files (save_photo):
    every jpeg_every-th view a JPEG with an EXIF focal length, the others
    PNGs. Returns the file paths."""
    import os

    os.makedirs(path, exist_ok=True)
    tex_far = make_texture(seed=seed, smooth_sigma=3.0)
    tex_near = make_texture(seed=seed + 100, smooth_sigma=3.0)
    paths = []
    for i, cam in enumerate(make_cameras(n_views, spread=0.55, seed=seed)):
        img = render_two_plane_view(tex_far, tex_near, cam, width, height)
        jpeg = bool(jpeg_every) and i % jpeg_every == 0
        fname = os.path.join(path, f"photo_{i:03d}.{'jpg' if jpeg else 'png'}")
        save_photo(img, fname, focal_mm if jpeg else None)
        paths.append(fname)
    return paths
