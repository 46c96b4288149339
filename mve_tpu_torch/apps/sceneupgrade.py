"""sceneupgrade: legacy formats -> current formats
(reference: apps/sceneupgrade/sceneupgrade.cc).

Converts
  * legacy single-file binary ``.mve`` view containers (signature
    ``\\x89MVE\\n``, text headers + raw embeddings; view.cc:56-178) into
    current view directories (meta.ini + one file per embedding), and
  * legacy ``.sfm`` prebundle files (signature ``MVE_VIEWPORTS\\n``;
    sceneupgrade.cc:38-141) into the current ``MVE_PREBUNDLE\\n`` format.

INPUT may be a single .mve view file, a single .sfm prebundle, or a scene
directory (all views/*.mve files plus any *.sfm in the scene root are
upgraded, mirroring sceneupgrade.cc convert_scene). Original files are
renamed to *.orig during conversion and deleted unless --keep-original.
A port of mve_tpu/apps/sceneupgrade.py, host numpy.

    python -m mve_tpu_torch.apps.sceneupgrade [-k] <scene|view.mve|prebundle.sfm>
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

from ..core.view import View, _Proxy
from ..sfm.bundler import common as bundler_common

LEGACY_VIEW_SIGNATURE = b"\x89MVE\n"
LEGACY_VIEWPORTS_SIGNATURE = b"MVE_VIEWPORTS\n"
LEGACY_MATCHING_SIGNATURE = b"MVE_MATCHING\n"

# image_base.h:267-291 type strings -> numpy dtypes
_TYPE_FOR_STRING = {
    "sint8": np.int8, "sint16": np.int16, "sint32": np.int32,
    "sint64": np.int64, "uint8": np.uint8, "uint16": np.uint16,
    "uint32": np.uint32, "uint64": np.uint64,
    "float": np.float32, "double": np.float64,
}


def parse_legacy_view(path: str) -> View:
    """Parse a deprecated single-file .mve container (view.cc:56-178)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(LEGACY_VIEW_SIGNATURE):
        raise IOError(f"{path}: invalid legacy view signature")

    view = View()
    off = len(LEGACY_VIEW_SIGNATURE)
    # (name, width, height, channels, dtype) for images; (name, size) blobs
    schedule = []
    while True:
        nl = data.find(b"\n", off)
        if nl < 0:
            raise IOError(f"{path}: premature EOF while reading headers")
        line = data[off:nl].decode("utf-8", "replace").strip()
        off = nl + 1
        if line == "end_headers":
            break
        tokens = line.split()
        if not tokens:
            raise IOError(f"{path}: invalid header line")
        if tokens[0] == "image" and len(tokens) == 6:
            name = tokens[1]
            w, h, c = int(tokens[2]), int(tokens[3]), int(tokens[4])
            dtype = _TYPE_FOR_STRING.get(tokens[5])
            if dtype is None:
                raise IOError(f"{path}: unknown image type {tokens[5]}")
            schedule.append(("image", name, w, h, c, dtype))
        elif tokens[0] == "data" and len(tokens) == 3:
            schedule.append(("blob", tokens[1], int(tokens[2])))
        elif tokens[0] == "id" and len(tokens) == 2:
            view.set_value("view.id", tokens[1])
        elif tokens[0] == "name" and len(tokens) > 1:
            view.set_value("view.name", " ".join(tokens[1:]))
        elif tokens[0] == "camera-ext" and len(tokens) == 13:
            view.set_value("camera.translation", " ".join(tokens[1:4]))
            view.set_value("camera.rotation", " ".join(tokens[4:13]))
        elif tokens[0] == "camera-int" and 2 <= len(tokens) <= 7:
            view.set_value("camera.focal_length", tokens[1])
            if len(tokens) > 3:
                view.set_value("camera.radial_distortion",
                               " ".join(tokens[2:4]))
            if len(tokens) > 4:
                view.set_value("camera.pixel_aspect", tokens[4])
            if len(tokens) > 6:
                view.set_value("camera.principal_point",
                               " ".join(tokens[5:7]))
        else:
            print(f"Unrecognized header: {line}", file=sys.stderr)

    # Payload: per embedding one text line (last token = byte size), then
    # the raw bytes, then one separator byte (view.cc:156-176).
    for entry in schedule:
        nl = data.find(b"\n", off)
        if nl < 0:
            raise IOError(f"{path}: premature EOF while reading payload")
        tokens = data[off:nl].decode("utf-8", "replace").split()
        if len(tokens) != 3:
            raise IOError(f"{path}: invalid embedding line")
        byte_size = int(tokens[2])
        off = nl + 1
        if entry[0] == "image":
            _, name, w, h, c, dtype = entry
            expected = w * h * c * np.dtype(dtype).itemsize
            if byte_size != expected:
                raise IOError(f"{path}: unexpected embedding size for {name}")
            img = np.frombuffer(data, dtype, w * h * c, off).reshape(h, w, c)
            # "original" is immutable through set_image; install directly.
            proxy = _Proxy(name, data=img.copy(), dirty=True)
            view._images[name] = proxy
        else:
            _, name, size = entry
            if byte_size != size:
                raise IOError(f"{path}: unexpected blob size for {name}")
            view.set_blob(name, data[off:off + byte_size])
        off += byte_size + 1  # embedding bytes + separator newline
    if off > len(data):
        raise IOError(f"{path}: premature EOF while reading payload")
    return view


def parse_legacy_prebundle(path: str):
    """Parse an old-format prebundle (sceneupgrade.cc:38-141). Returns
    (viewports, matching) ready for the current serializer; feature
    positions are normalized when image dims were recorded."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(LEGACY_VIEWPORTS_SIGNATURE):
        raise IOError(f"{path}: not in old prebundle format")
    off = len(LEGACY_VIEWPORTS_SIGNATURE)

    def read_i32():
        nonlocal off
        (val,) = struct.unpack_from("<i", data, off)
        off += 4
        return val

    num_viewports = read_i32()
    viewports = []
    for _ in range(num_viewports):
        vp = bundler_common.Viewport()
        width = read_i32()
        height = read_i32()
        vp.focal_length, rd = struct.unpack_from("<ff", data, off)
        vp.radial_distortion = np.array([rd, rd], np.float64)
        off += 8
        n_pos = read_i32()
        pos = np.frombuffer(data, "<f4", n_pos * 2, off).reshape(n_pos, 2)
        off += n_pos * 8
        if width > 0 and height > 0:
            pos = bundler_common.normalize_feature_positions(
                pos.astype(np.float64), width, height)
        vp.positions = np.asarray(pos, np.float32)
        vp.width, vp.height = width, height
        n_col = read_i32()
        vp.colors = np.frombuffer(
            data, np.uint8, n_col * 3, off).reshape(n_col, 3).copy()
        off += n_col * 3
        n_tid = read_i32()
        vp.track_ids = np.frombuffer(data, "<i4", n_tid, off).copy()
        off += n_tid * 4
        viewports.append(vp)

    if data[off:off + len(LEGACY_MATCHING_SIGNATURE)] != \
            LEGACY_MATCHING_SIGNATURE:
        raise IOError(f"{path}: invalid matching signature")
    off += len(LEGACY_MATCHING_SIGNATURE)

    matching = []
    num_pairs = read_i32()
    for _ in range(num_pairs):
        v1 = read_i32()
        v2 = read_i32()
        n = read_i32()
        m = np.frombuffer(data, "<i4", n * 2, off).reshape(n, 2).copy()
        off += n * 8
        matching.append(bundler_common.TwoViewMatching(v1, v2, m))
    return viewports, matching


def convert_view(path: str, keep_original: bool = False,
                 verbose: bool = True) -> None:
    if os.path.isdir(path):
        if verbose:
            print(f"View {os.path.basename(path)} is a directory, skipping.")
        return
    if verbose:
        print(f"Converting {os.path.basename(path)}...")
    orig = path + ".orig"
    os.rename(path, orig)
    try:
        view = parse_legacy_view(orig)
        view.save_view_as(path)
    except Exception:
        os.rename(orig, path)
        raise
    if not keep_original:
        os.unlink(orig)


def convert_prebundle(path: str, keep_original: bool = False,
                      verbose: bool = True) -> None:
    with open(path, "rb") as f:
        sig = f.read(len(LEGACY_VIEWPORTS_SIGNATURE))
    if sig != LEGACY_VIEWPORTS_SIGNATURE:
        if verbose:
            print(f"Skipping {os.path.basename(path)}: "
                  "Not in old prebundle format.")
        return
    if verbose:
        print(f"Converting prebundle: {os.path.basename(path)}")
    orig = path + ".orig"
    os.rename(path, orig)
    try:
        viewports, matching = parse_legacy_prebundle(orig)
        bundler_common.save_prebundle(viewports, matching, path)
    except Exception:
        os.rename(orig, path)
        raise
    if not keep_original:
        os.unlink(orig)


def scene_upgrade(input_path: str, keep_original: bool = False,
                  verbose: bool = True) -> None:
    """Upgrade a scene dir, a single .mve view, or a .sfm prebundle."""
    if os.path.isdir(input_path) and not input_path.endswith(".mve"):
        views_dir = os.path.join(input_path, "views")
        if os.path.isdir(views_dir):
            for name in sorted(os.listdir(views_dir)):
                if name.endswith(".mve"):
                    convert_view(os.path.join(views_dir, name),
                                 keep_original, verbose)
        for name in sorted(os.listdir(input_path)):
            if name.endswith(".sfm"):
                convert_prebundle(os.path.join(input_path, name),
                                  keep_original, verbose)
    elif input_path.endswith(".mve"):
        convert_view(input_path, keep_original, verbose)
    elif input_path.endswith(".sfm"):
        convert_prebundle(input_path, keep_original, verbose)
    else:
        raise IOError(f"Unknown file extension: {input_path}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sceneupgrade",
        description="Upgrade an MVE view, prebundle file, or scene "
                    "to the current format.")
    p.add_argument("-k", "--keep-original", action="store_true",
                   help="Keep original files")
    p.add_argument("input", help="View file, prebundle file, or scene dir")
    args = p.parse_args(argv)
    scene_upgrade(args.input, args.keep_original)
    return 0


if __name__ == "__main__":
    sys.exit(main())
