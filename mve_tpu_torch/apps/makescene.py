"""makescene: images / SfM workspaces -> MVE scene directory
(reference: apps/makescene/makescene.cc; port of mve_tpu/apps/makescene.py).

Supported inputs:
- a directory of images (``-i``): one view per image with the original
  embedding and an "exif" blob for JPEGs (makescene.cc:969 import_images);
- an NVM file or COLMAP model directory: views + synth_0.out bundle
  with undistorted images (makescene.cc:341 import_bundle_nvm_or_colmap);
- a Photosynther or Noah Bundler workspace (makescene.cc:514).

The image rescale, the thumbnails and the Bundler undistortion run on the
device; the rest is host I/O. Given the same input, the scene directory
is byte-identical to mve_tpu's, except that a thumbnail pixel whose value
lies within rounding of a half level can round the other way.

    python -m mve_tpu_torch.apps.makescene [--device cpu] -i <images> <scene>
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from ..core import Scene, View, CameraInfo
from ..core import image_io, bundle_io, image_tools

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".ppm", ".pgm", ".pfm", ".bmp")


def _parse_init_intrinsics(spec: str) -> CameraInfo:
    """'f[,k1,k2[,ppx,ppy[,pa]]]' -> CameraInfo (makescene.cc:1053-1075)."""
    vals = [float(x) for x in spec.split(",") if x != ""]
    cam = CameraInfo()
    if len(vals) > 0:
        cam.flen = vals[0]
    if len(vals) >= 3:
        cam.dist = np.array(vals[1:3], np.float32)
    if len(vals) >= 5:
        cam.ppoint = np.array(vals[3:5], np.float32)
    if len(vals) >= 6:
        cam.paspect = vals[5]
    return cam


def _half_size_bytes(img: np.ndarray, dev: torch.device) -> np.ndarray:
    """One 2x2 box half-size of a byte image on the device, rounded back to
    bytes on the host (mve_tpu's to_byte(rescale_half_size(to_float(img))))."""
    x = torch.from_numpy(image_tools.to_float(img)).to(dev)
    return image_tools.to_byte(image_tools.rescale_half_size(x).cpu().numpy())


def import_images(input_dir: str, scene_path: str, max_pixels: int = 0,
                  append: bool = False, init_intrinsics: str = "",
                  device="cuda") -> int:
    """One view per image (makescene.cc import_images). ``append`` adds the
    images to an existing scene continuing from the highest view ID
    (makescene.cc:985-1005); ``init_intrinsics`` seeds each view's camera
    from 'f,k1,k2,ppx,ppy,pa' (makescene.cc:1053-1075)."""
    dev = resolve_device(device)
    if append:
        scene = Scene(scene_path)
        view_id = 1 + max((v.id for v in scene.views if v is not None),
                          default=-1)
    else:
        scene = Scene.create(scene_path)
        view_id = 0
    files = sorted(
        f for f in os.listdir(input_dir)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    n_imported = 0
    for fname in files:
        src = os.path.join(input_dir, fname)
        try:
            img = image_io.load_image(src)
        except Exception as exc:
            print(f"Skipping {fname}: {exc}", file=sys.stderr)
            continue
        while max_pixels > 0 and img.shape[0] * img.shape[1] > max_pixels:
            img = _half_size_bytes(img, dev)
        view = View.create(scene.view_dir_for_id(view_id), view_id,
                           os.path.splitext(fname)[0])
        view.set_image("thumbnail", image_tools.create_thumbnail(
            image_tools.to_byte(image_tools.to_float(img)), device=dev))
        exif = b""
        if os.path.splitext(fname)[1].lower() in (".jpg", ".jpeg"):
            exif = image_io.load_jpeg_exif(src)
        if exif:
            view.set_blob("exif", exif)
        if init_intrinsics:
            view.set_camera(_parse_init_intrinsics(init_intrinsics))
        if max_pixels > 0:
            view.set_original_image(img)
            view.save_view()
        else:
            view.save_view_as(view.get_directory(), original_src=src)
        scene.add_view(view)
        view_id += 1
        n_imported += 1
    print(f"Imported {n_imported} images into {scene_path}")
    return n_imported


def import_bundle(input_path: str, scene_path: str, fmt: str = "auto",
                  scale: int = -1, device="cuda") -> int:
    """NVM file or COLMAP model/workspace dir -> scene + bundle.

    For COLMAP workspaces with stereo depth maps, ``scale >= 0`` also
    imports each view's depth map as a ``depth-L<scale>`` embedding in
    MVE's ray-length convention (and ``undist-L<scale>`` for scale >= 1),
    matching makescene.cc:440-481.
    """
    dev = resolve_device(device)
    if fmt == "auto":
        fmt = "nvm" if input_path.endswith(".nvm") else "colmap"
    if fmt == "nvm":
        bundle, meta = bundle_io.load_nvm_bundle(input_path)
        base = os.path.dirname(input_path)
    else:
        bundle, meta = bundle_io.load_colmap_bundle(input_path)
        base = (os.path.join(input_path, "images")
                if os.path.isdir(os.path.join(input_path, "images"))
                else os.path.join(input_path, "..", "images"))
    scene = Scene.create(scene_path)
    for i, (cam, m) in enumerate(zip(bundle.cameras, meta)):
        view = View.create(scene.view_dir_for_id(i), i,
                           os.path.splitext(os.path.basename(m["filename"]))[0])
        img_path = m["filename"]
        if not os.path.isabs(img_path):
            img_path = os.path.join(base, img_path)
        img = None
        if os.path.isfile(img_path):
            img = image_io.load_image(img_path)
            h, w = img.shape[:2]
            if fmt == "nvm" and cam.flen > 10:  # pixel-unit focal from NVM
                cam = cam.copy()
                cam.flen = cam.flen / max(w, h)
            view.set_image("undistorted", img)
        if (fmt == "colmap" and img is not None and scale >= 0
                and m.get("depth_map")):
            h, w = img.shape[:2]
            depth = bundle_io.load_colmap_depth_map(
                scale, cam, w, h, m["depth_map"])
            view.set_image(f"depth-L{scale}", np.asarray(depth, np.float32))
            if scale >= 1:
                und = img
                for _ in range(scale):
                    und = _half_size_bytes(und, dev)
                view.set_image(f"undist-L{scale}", und)
        view.set_camera(cam)
        view.save_view()
        scene.add_view(view)
    scene.set_bundle(bundle)
    scene.save_bundle()
    print(f"Imported bundle with {len(bundle.cameras)} cameras into {scene_path}")
    return len(bundle.cameras)


def import_bundle_noah_ps(input_path: str, scene_path: str, *,
                          bundle_id: int = 0, import_original: bool = False,
                          keep_invalid: bool = False, device="cuda") -> int:
    """Photosynther / Noah Bundler workspace -> scene
    (makescene.cc:514 import_bundle_noah_ps).

    Photosynther layout: bundle/synth_N.out + images/ (+ undistorted/);
    Bundler layout: bundle/bundle.out + list.txt (+ images at listed paths).
    """
    dev = resolve_device(device)
    bundle_dir = os.path.join(input_path, "bundle")
    fmt = None
    bundle_fname = os.path.join(bundle_dir, f"synth_{bundle_id}.out")
    if os.path.isfile(bundle_fname):
        fmt = "photosynther"
    else:
        name = "bundle.out" if bundle_id == 0 else f"bundle_{bundle_id:03d}.out"
        bundle_fname = os.path.join(bundle_dir, name)
        if os.path.isfile(bundle_fname):
            fmt = "bundler"
    if fmt is None:
        raise IOError(f"{input_path}: could not detect bundle format")

    if fmt == "photosynther":
        bundle = bundle_io.load_photosynther_bundle(bundle_fname)
        undist_dir = os.path.join(input_path, "undistorted")
        image_files = sorted(
            os.path.join(undist_dir, f) for f in os.listdir(undist_dir)
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS) if os.path.isdir(undist_dir) else []
    else:
        bundle = bundle_io.load_bundler_bundle(bundle_fname)
        listfile = os.path.join(input_path, "list.txt")
        image_files = []
        if os.path.isfile(listfile):
            with open(listfile) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        path = parts[0]
                        if not os.path.isabs(path):
                            path = os.path.join(input_path, path)
                        image_files.append(path)

    scene = Scene.create(scene_path)
    n = len(bundle.cameras)
    for i in range(n):
        cam = bundle.cameras[i]
        # Views with invalid cameras are skipped unless -k/--keep-invalid
        # (makescene.cc:642,669 skip_invalid).
        if cam.flen == 0.0 and not keep_invalid:
            continue
        view = View.create(scene.view_dir_for_id(i), i)
        img = None
        if i < len(image_files) and os.path.isfile(image_files[i]):
            img = image_io.load_image(image_files[i])
            view.name = os.path.splitext(os.path.basename(image_files[i]))[0]
        if cam.flen > 0 and img is not None:
            if fmt == "photosynther":
                # Photosynther images are already undistorted.
                view.set_image("undistorted", img)
            else:
                # Bundler: undistort with the k2k4 model (makescene.cc
                # import path undistorts originals).
                und = image_tools.image_undistort_k2k4(
                    image_tools.to_float(img), float(cam.flen),
                    float(cam.dist[0]), float(cam.dist[1]), device=dev)
                view.set_image("undistorted", image_tools.to_byte(und))
            if import_original:
                view.set_original_image(img)
        # Normalize camera: Bundler focal is in pixels.
        cam = cam.copy()
        if fmt == "bundler" and img is not None and cam.flen > 10.0:
            cam.flen = cam.flen / max(img.shape[0], img.shape[1])
        view.set_camera(cam)
        view.save_view()
        scene.add_view(view)
    scene.set_bundle(bundle)
    scene.save_bundle()
    print(f"Imported {fmt} bundle with {n} cameras into {scene_path}")
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="makescene", description="Create MVE scene from images or SfM exports.")
    p.add_argument("input", help="Input directory (images or COLMAP model) or NVM file")
    p.add_argument("scene", help="Output scene directory")
    p.add_argument("-i", "--images-only", action="store_true",
                   help="Import images from INPUT_DIR only")
    p.add_argument("-m", "--max-pixels", type=int, default=0,
                   help="Limit image size by iterative half-sizing")
    p.add_argument("-b", "--bundle-id", type=int, default=0,
                   help="Bundle ID (Photosynther and Bundler only)")
    p.add_argument("-o", "--original", action="store_true",
                   help="Import original images (bundle workspaces)")
    p.add_argument("-a", "--append-images", action="store_true",
                   help="Append images to an existing scene (with -i)")
    p.add_argument("-c", "--init-intrinsics", default="",
                   help="Initial camera intrinsics 'f,k1,k2,ppx,ppy,pa'")
    p.add_argument("-s", "--scale", type=int, default=-1,
                   help="Import COLMAP depth maps at this pyramid scale")
    p.add_argument("-k", "--keep-invalid", action="store_true",
                   help="Keeps images with invalid cameras")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda or cpu [cuda]")
    args = p.parse_args(argv)

    if args.append_images and not args.images_only:
        p.error("Cannot --append-images without --images-only")

    def _is_colmap(path):
        return (os.path.isfile(os.path.join(path, "cameras.txt"))
                or os.path.isfile(os.path.join(path, "cameras.bin"))
                or os.path.isdir(os.path.join(path, "sparse")))

    if args.images_only:
        import_images(args.input, args.scene, args.max_pixels,
                      append=args.append_images,
                      init_intrinsics=args.init_intrinsics, device=args.device)
    elif os.path.isdir(os.path.join(args.input, "bundle")):
        import_bundle_noah_ps(args.input, args.scene, bundle_id=args.bundle_id,
                              import_original=args.original,
                              keep_invalid=args.keep_invalid, device=args.device)
    elif os.path.isdir(args.input) and not _is_colmap(args.input):
        import_images(args.input, args.scene, args.max_pixels,
                      init_intrinsics=args.init_intrinsics, device=args.device)
    else:
        import_bundle(args.input, args.scene, scale=args.scale, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
