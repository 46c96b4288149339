"""Bundle file I/O (reference: libs/mve/bundle_io.cc; a host numpy copy of
mve_tpu/core/bundle_io.py).

Supported formats:

- MVE native == Photosynther text format ("drews 1.0" header), used for
  ``synth_0.out`` (bundle_io.cc:218-280 format doc, :430-500 writer).
- Noah Bundler v0.3 ("# Bundle file v0.3" header): same camera block,
  refs additionally carry image-centered float x/y (bundle_io.cc:242-264).
- VisualSFM NVM (bundle_io.cc:100-215).
- COLMAP models, text and binary, bare or as a workspace with depth maps
  (bundle_io.cc:498-1178).

The files this module writes are byte-identical to mve_tpu's.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..math.rotation import quat_to_matrix
from .bundle import Bundle, Feature2D, Feature3D
from .camera import CameraInfo


# ---------------------------------------------------------------------------
# MVE / Photosynther and Noah Bundler (common structure)
# ---------------------------------------------------------------------------

def load_mve_bundle(path: str) -> Bundle:
    return _load_bundler_ps(path, "photosynther")


def save_mve_bundle(bundle: Bundle, path: str) -> None:
    save_photosynther_bundle(bundle, path)


def load_photosynther_bundle(path: str) -> Bundle:
    return _load_bundler_ps(path, "photosynther")


def load_bundler_bundle(path: str) -> Bundle:
    return _load_bundler_ps(path, "bundler")


def _load_bundler_ps(path: str, fmt: str) -> Bundle:
    with open(path, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)

    def nxt():
        return next(it)

    # Header: "drews 1.0" or "# Bundle file v0.3"
    if fmt == "photosynther":
        magic = nxt() + " " + nxt()
        if magic != "drews 1.0":
            raise IOError(f"{path}: invalid Photosynther signature {magic!r}")
    else:
        magic = " ".join(nxt() for _ in range(4))
        if magic != "# Bundle file v0.3":
            raise IOError(f"{path}: invalid Bundler signature {magic!r}")

    num_cameras = int(nxt())
    num_features = int(nxt())
    bundle = Bundle()
    for _ in range(num_cameras):
        vals = np.array([float(nxt()) for _ in range(15)], np.float64)
        cam = CameraInfo()
        cam.flen = float(vals[0])
        cam.dist = vals[1:3].astype(np.float32)
        cam.rot = vals[3:12].reshape(3, 3).astype(np.float32)
        cam.trans = vals[12:15].astype(np.float32)
        bundle.cameras.append(cam)

    for _ in range(num_features):
        pos = np.array([float(nxt()) for _ in range(3)], np.float32)
        color = np.array([float(nxt()) for _ in range(3)], np.float32) / 255.0
        nrefs = int(nxt())
        refs = []
        for _ in range(nrefs):
            view_id = int(nxt())
            feat_id = int(nxt())
            if fmt == "photosynther":
                nxt()  # reprojection quality, discarded (bundle_io.cc:375)
                refs.append(Feature2D(view_id, feat_id))
            else:
                x = float(nxt())
                y = float(nxt())
                refs.append(Feature2D(view_id, feat_id, np.array([x, y], np.float32)))
        bundle.features.append(Feature3D(pos, color, refs))
    return bundle


def save_photosynther_bundle(bundle: Bundle, path: str) -> None:
    """Write the MVE native bundle (bundle_io.cc save_photosynther_bundle)."""
    lines = ["drews 1.0", f"{len(bundle.cameras)} {len(bundle.features)}"]
    for cam in bundle.cameras:
        valid = (
            cam.flen != 0.0
            and np.all(np.isfinite(cam.trans))
            and np.all(np.isfinite(cam.rot))
        )
        if not valid:
            lines.extend(["0 0 0"] * 5)
            continue
        r = cam.rot.reshape(-1)
        lines.append(f"{_fmt(cam.flen)} {_fmt(cam.dist[0])} {_fmt(cam.dist[1])}")
        lines.append(f"{_fmt(r[0])} {_fmt(r[1])} {_fmt(r[2])}")
        lines.append(f"{_fmt(r[3])} {_fmt(r[4])} {_fmt(r[5])}")
        lines.append(f"{_fmt(r[6])} {_fmt(r[7])} {_fmt(r[8])}")
        lines.append(f"{_fmt(cam.trans[0])} {_fmt(cam.trans[1])} {_fmt(cam.trans[2])}")
    for feat in bundle.features:
        lines.append(f"{_fmt(feat.pos[0])} {_fmt(feat.pos[1])} {_fmt(feat.pos[2])}")
        c = [int(x * 255.0 + 0.5) for x in feat.color]
        lines.append(f"{c[0]} {c[1]} {c[2]}")
        ref_str = " ".join(f"{r.view_id} {r.feature_id} 0" for r in feat.refs)
        lines.append(f"{len(feat.refs)}" + (" " + ref_str if ref_str else ""))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fmt(x: float) -> str:
    """Compact float formatting comparable to C++ operator<< defaults."""
    return f"{float(x):.9g}"


# ---------------------------------------------------------------------------
# VisualSFM NVM (bundle_io.cc:100-215)
# ---------------------------------------------------------------------------

def load_nvm_bundle(path: str):
    """Load an NVM_V3 file. Returns (bundle, camera_infos) where
    camera_infos is a list of dicts with image paths and radial distortion
    (NVM stores distortion separately from the bundle camera model)."""
    with open(path, "r") as f:
        content = f.read().split("\n")
    idx = 0

    def next_nonempty():
        nonlocal idx
        while idx < len(content) and not content[idx].strip():
            idx += 1
        line = content[idx]
        idx += 1
        return line

    header = next_nonempty().strip()
    if not header.startswith("NVM_V3"):
        raise IOError(f"{path}: invalid NVM signature")
    num_views = int(next_nonempty())
    bundle = Bundle()
    view_meta = []
    for _ in range(num_views):
        parts = next_nonempty().split()
        name = parts[0]
        flen_px = float(parts[1])
        quat = np.array([float(x) for x in parts[2:6]])
        center = np.array([float(x) for x in parts[6:9]])
        k1 = float(parts[9])
        cam = CameraInfo()
        R = np.asarray(quat_to_matrix(quat))
        cam.rot = R.astype(np.float32)
        cam.trans = (-R @ center).astype(np.float32)
        cam.flen = flen_px  # pixel units; normalized by caller w/ image dims
        view_meta.append({"filename": name, "focal_px": flen_px, "nvm_k1": k1})
        bundle.cameras.append(cam)
    num_features = int(next_nonempty())
    for _ in range(num_features):
        parts = next_nonempty().split()
        pos = np.array([float(x) for x in parts[0:3]], np.float32)
        color = np.array([float(x) for x in parts[3:6]], np.float32) / 255.0
        nrefs = int(parts[6])
        refs = []
        for r in range(nrefs):
            base = 7 + r * 4
            refs.append(
                Feature2D(
                    int(parts[base]),
                    int(parts[base + 1]),
                    np.array([float(parts[base + 2]), float(parts[base + 3])], np.float32),
                )
            )
        bundle.features.append(Feature3D(pos, color, refs))
    return bundle, view_meta


# ---------------------------------------------------------------------------
# COLMAP models (bundle_io.cc:498-1106): text and binary sparse models,
# bare model dirs and full workspaces (sparse/ + images/ + stereo/depth_maps).
# ---------------------------------------------------------------------------

#: COLMAP camera model code -> name (bundle_io.cc:501-513 define_camera_models)
COLMAP_MODEL_CODES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}

#: Parameter counts per model (colmap camera_models.h; reference reads only
#: the first three, bundle_io.cc:805-817).
COLMAP_MODEL_NUM_PARAMS = {
    "SIMPLE_PINHOLE": 3, "PINHOLE": 4, "SIMPLE_RADIAL": 4, "RADIAL": 5,
    "OPENCV": 8, "OPENCV_FISHEYE": 8, "FULL_OPENCV": 12, "FOV": 5,
    "SIMPLE_RADIAL_FISHEYE": 4, "RADIAL_FISHEYE": 5, "THIN_PRISM_FISHEYE": 12,
}


def _colmap_camera_from_params(model: str, params, width: int, height: int) -> CameraInfo:
    """COLMAP intrinsics -> normalized MVE CameraInfo
    (bundle_io.cc:533-575 create_camera_info_from_params).

    Like the reference, only distortion-free models map exactly; radial
    models keep k1/k2 in ``dist`` so callers can reject or undistort.
    """
    cam = CameraInfo()
    maxdim = float(max(width, height))
    if model == "SIMPLE_PINHOLE":
        cam.flen = params[0] / maxdim
        cam.ppoint = np.array([params[1] / width, params[2] / height], np.float32)
    elif model == "PINHOLE":
        fx, fy = params[0], params[1]
        pixel_aspect = fy / fx
        img_aspect = (width / height) * pixel_aspect
        cam.flen = (fy / height) if img_aspect < 1.0 else (fx / width)
        cam.paspect = float(pixel_aspect)
        cam.ppoint = np.array([params[2] / width, params[3] / height], np.float32)
    elif model in ("SIMPLE_RADIAL", "RADIAL"):
        cam.flen = params[0] / maxdim
        cam.ppoint = np.array([params[1] / width, params[2] / height], np.float32)
        k = list(params[3:5]) + [0.0]
        cam.dist = np.array(k[:2], np.float32)
    elif model == "OPENCV":
        cam.flen = 0.5 * (params[0] + params[1]) / maxdim
        cam.ppoint = np.array([params[2] / width, params[3] / height], np.float32)
        cam.dist = np.array(params[4:6], np.float32)
    else:
        raise IOError(
            f"Unsupported COLMAP camera model {model}; re-run COLMAP with "
            "SIMPLE_PINHOLE/PINHOLE or use its undistortion step first "
            "(matches reference bundle_io.cc:565-574)")
    return cam


def _read_colmap_cameras_txt(path: str) -> dict:
    intrinsics = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            intrinsics[cam_id] = {
                "model": parts[1],
                "width": int(parts[2]), "height": int(parts[3]),
                "params": [float(x) for x in parts[4:]],
            }
    return intrinsics


def _read_colmap_cameras_bin(path: str) -> dict:
    """cameras.bin (bundle_io.cc:819-847): u64 count, then per camera
    u32 id, i32 model code, u64 width, u64 height, f64 params[n]."""
    intrinsics = {}
    with open(path, "rb") as f:
        (count,) = struct.unpack("<Q", f.read(8))
        for _ in range(count):
            cam_id, code = struct.unpack("<Ii", f.read(8))
            width, height = struct.unpack("<QQ", f.read(16))
            model = COLMAP_MODEL_CODES.get(code)
            if model is None:
                raise IOError(f"{path}: unknown COLMAP camera model code {code}")
            n = COLMAP_MODEL_NUM_PARAMS[model]
            params = list(struct.unpack(f"<{n}d", f.read(8 * n)))
            intrinsics[cam_id] = {"model": model, "width": int(width),
                                  "height": int(height), "params": params}
    return intrinsics


def _read_colmap_images_txt(path: str):
    """images.txt: two lines per image — pose line + POINT2D line.
    Returns list of dicts (in file order) with colmap ids and 2D points."""
    # Keep empty lines: an image with zero POINT2Ds still occupies its
    # second line (reference reads strictly two getlines per image,
    # bundle_io.cc:687-745); only comment lines are dropped.
    with open(path) as f:
        lines = [l.strip() for l in f if not l.lstrip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    images = []
    for i in range(0, len(lines), 2):
        if not lines[i]:
            break
        parts = lines[i].split()
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        pts2d = np.array([float(x) for x in pts], np.float64).reshape(-1, 3) \
            if pts else np.zeros((0, 3))
        images.append({
            "image_id": int(parts[0]),
            "quat": np.array([float(x) for x in parts[1:5]]),
            "trans": np.array([float(x) for x in parts[5:8]]),
            "camera_id": int(parts[8]),
            "name": parts[9],
            "xy": pts2d[:, :2].astype(np.float32),
            "p3d_ids": pts2d[:, 2].astype(np.int64),
        })
    return images


def _read_colmap_images_bin(path: str):
    """images.bin (bundle_io.cc:849-926): u64 count, then per image u32 id,
    f64 quat[4], f64 trans[3], u32 camera id, NUL-terminated name,
    u64 n_points2D, (f64 x, f64 y, u64 point3D id)*n."""
    images = []
    with open(path, "rb") as f:
        (count,) = struct.unpack("<Q", f.read(8))
        for _ in range(count):
            (image_id,) = struct.unpack("<I", f.read(4))
            vals = struct.unpack("<7d", f.read(56))
            (camera_id,) = struct.unpack("<I", f.read(4))
            name = bytearray()
            while True:
                c = f.read(1)
                if not c or c == b"\x00":
                    break
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            raw = np.frombuffer(f.read(24 * n_pts), dtype=np.dtype("<u1"))
            rec = raw.view(np.dtype([("x", "<f8"), ("y", "<f8"), ("p3d", "<u8")]))
            images.append({
                "image_id": image_id,
                "quat": np.array(vals[0:4]),
                "trans": np.array(vals[4:7]),
                "camera_id": camera_id,
                "name": name.decode("utf-8"),
                "xy": np.stack([rec["x"], rec["y"]], -1).astype(np.float32)
                    if n_pts else np.zeros((0, 2), np.float32),
                "p3d_ids": rec["p3d"].astype(np.int64) if n_pts else np.zeros(0, np.int64),
            })
    return images


def _read_colmap_points3d_txt(path: str):
    points = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            track = parts[8:]
            points.append({
                "pos": np.array([float(x) for x in parts[1:4]], np.float32),
                "color": np.array([float(x) for x in parts[4:7]], np.float32) / 255.0,
                "track": [(int(track[j]), int(track[j + 1]))
                          for j in range(0, len(track), 2)],
            })
    return points


def _read_colmap_points3d_bin(path: str):
    """points3D.bin (bundle_io.cc:928-1016): u64 count, then per point
    u64 id, f64 xyz[3], u8 rgb[3], f64 error, u64 track_len,
    (u32 image_id, u32 point2D_idx)*len."""
    points = []
    with open(path, "rb") as f:
        (count,) = struct.unpack("<Q", f.read(8))
        for _ in range(count):
            _p3d_id = struct.unpack("<Q", f.read(8))[0]
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            _err = struct.unpack("<d", f.read(8))[0]
            (tlen,) = struct.unpack("<Q", f.read(8))
            raw = np.frombuffer(f.read(8 * tlen), dtype=np.dtype("<u4")).reshape(-1, 2)
            points.append({
                "pos": np.array(xyz, np.float32),
                "color": np.array(rgb, np.float32) / 255.0,
                "track": [(int(a), int(b)) for a, b in raw],
            })
    return points


def _determine_depth_map_path(depth_dir: str, image_name: str):
    """Prefer geometric over photometric depth maps
    (bundle_io.cc:644-658 determine_depth_map_path)."""
    for kind in ("geometric", "photometric"):
        p = os.path.join(depth_dir, f"{image_name}.{kind}.bin")
        if os.path.isfile(p):
            return p
    return None


def load_colmap_bundle(path: str):
    """Load a COLMAP reconstruction. Returns ``(bundle, view_meta)``.

    ``path`` may be a bare sparse-model directory (cameras/images/points3D
    in .txt or .bin form) or a full COLMAP workspace containing ``sparse/``,
    ``images/`` and optionally ``stereo/depth_maps/``
    (bundle_io.cc:1019-1106 load_colmap_bundle). ``view_meta`` entries carry
    filename, image dims, and the per-view depth-map path when present.
    """
    workspace = None
    model_dir = path
    if not (os.path.isfile(os.path.join(path, "cameras.txt"))
            or os.path.isfile(os.path.join(path, "cameras.bin"))):
        sparse = os.path.join(path, "sparse")
        if os.path.isdir(sparse):
            workspace, model_dir = path, sparse
            # COLMAP often nests models as sparse/0/
            if not (os.path.isfile(os.path.join(sparse, "cameras.txt"))
                    or os.path.isfile(os.path.join(sparse, "cameras.bin"))):
                sub = os.path.join(sparse, "0")
                if os.path.isdir(sub):
                    model_dir = sub
        else:
            raise IOError(f"{path}: no COLMAP model found (cameras.txt/.bin)")
    depth_dir = os.path.join(workspace, "stereo", "depth_maps") if workspace else None

    cams_txt = os.path.join(model_dir, "cameras.txt")
    intrinsics = (_read_colmap_cameras_txt(cams_txt) if os.path.isfile(cams_txt)
                  else _read_colmap_cameras_bin(os.path.join(model_dir, "cameras.bin")))
    images_txt = os.path.join(model_dir, "images.txt")
    images = (_read_colmap_images_txt(images_txt) if os.path.isfile(images_txt)
              else _read_colmap_images_bin(os.path.join(model_dir, "images.bin")))
    points_txt = os.path.join(model_dir, "points3D.txt")
    points = (_read_colmap_points3d_txt(points_txt) if os.path.isfile(points_txt)
              else _read_colmap_points3d_bin(os.path.join(model_dir, "points3D.bin")))

    bundle = Bundle()
    view_meta = []
    image_id_to_index = {}
    for img in images:
        info = intrinsics[img["camera_id"]]
        cam = _colmap_camera_from_params(
            info["model"], info["params"], info["width"], info["height"])
        cam.rot = np.asarray(quat_to_matrix(img["quat"])).astype(np.float32)
        cam.trans = np.asarray(img["trans"], np.float32)
        image_id_to_index[img["image_id"]] = len(bundle.cameras)
        bundle.cameras.append(cam)
        meta = {"filename": img["name"], "width": info["width"],
                "height": info["height"], "depth_map": None}
        if depth_dir:
            meta["depth_map"] = _determine_depth_map_path(depth_dir, img["name"])
        view_meta.append(meta)

    # points3D tracks reference (image_id, point2D_idx); fill observation
    # positions from the images' POINT2D arrays like the reference
    # (bundle_io.cc:986-1003).
    xy_by_index = {image_id_to_index[img["image_id"]]: img["xy"] for img in images}
    for pt in points:
        refs = []
        for img_id, pt2d_id in pt["track"]:
            if img_id not in image_id_to_index:
                continue
            vid = image_id_to_index[img_id]
            xy = xy_by_index.get(vid)
            pos = (xy[pt2d_id] if xy is not None and pt2d_id < len(xy)
                   else np.zeros(2, np.float32))
            refs.append(Feature2D(vid, int(pt2d_id), np.asarray(pos, np.float32)))
        bundle.features.append(Feature3D(pt["pos"], pt["color"], refs))
    return bundle, view_meta


def parse_colmap_depth_map(path: str) -> np.ndarray:
    """Read a COLMAP .bin depth map: ASCII ``w&h&c&`` header followed by
    little-endian float32 row-major data (bundle_io.cc:1108-1138)."""
    with open(path, "rb") as f:
        data = f.read()
    idx, dims = 0, []
    for _ in range(3):
        amp = data.index(b"&", idx)
        dims.append(int(data[idx:amp]))
        idx = amp + 1
    w, h, c = dims
    if w <= 0 or h <= 0 or c != 1:
        raise IOError(f"{path}: invalid COLMAP depth map header {dims}")
    arr = np.frombuffer(data, np.dtype("<f4"), count=w * h, offset=idx)
    return arr.reshape(h, w).astype(np.float32)


def load_colmap_depth_map(scale: int, cam: CameraInfo, original_width: int,
                          original_height: int, path: str) -> np.ndarray:
    """COLMAP z-depth map -> MVE ray-length depth at pyramid level ``scale``
    (bundle_io.cc:1140-1178 load_colmap_depth_map): convert conventions with
    the inverse calibration, then halve by subsampling ``scale`` times.
    Sizes must match the undistorted image exactly."""
    from . import image_tools
    from .depthmap import depthmap_convert_conventions

    depth = parse_colmap_depth_map(path)
    if depth.shape != (original_height, original_width):
        raise IOError(
            f"COLMAP depth map {depth.shape[1]}x{depth.shape[0]} does not "
            f"match undistorted image {original_width}x{original_height}; "
            "re-compute depth maps without limiting their size")
    inv_calib = cam.inverse_calibration(original_width, original_height)
    depth = depthmap_convert_conventions(depth, inv_calib, to_mve=True)
    for _ in range(max(0, scale)):
        depth = image_tools.rescale_half_size_subsample(depth)
    return np.asarray(depth, np.float32)
