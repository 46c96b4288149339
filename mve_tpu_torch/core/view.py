"""File-system view representation (reference: libs/mve/view.h/.cc).

A view is one directory ``view_NNNN.mve/`` containing:

    meta.ini          — [view] id/name + [camera] parameters (view.h:22-33)
    <name>.<ext>      — one file per image embedding (png/jpg/mvei/...)
    <name>.blob       — one file per BLOB embedding (e.g. EXIF, descriptors)

Behavioral contracts kept from the reference:

- Lazy loading: directory scan registers proxies; pixel data is read on
  first access (view.h:86-133).
- Dirty tracking: only changed embeddings are rewritten on save
  (view.h:88-133).
- Lossless re-encode policy: a modified image embedding is saved as PNG
  for 1-4 uint8 channels, MVEI otherwise, and a stale lossy original file
  is deleted (view.h:35-37, view.cc:846-862).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import numpy as np

from ..utils.ini import parse_ini_file, save_ini_file
from .camera import CameraInfo
from . import image_io

META_FILE = "meta.ini"
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tiff", ".tif", ".mvei", ".pfm", ".ppm", ".pgm")


class _Proxy:
    __slots__ = ("name", "filename", "data", "dirty", "is_image")

    def __init__(self, name, filename=None, data=None, dirty=False, is_image=True):
        self.name = name
        self.filename = filename  # relative to view dir; None if never saved
        self.data = data  # numpy array (image) or bytes (blob); None = not loaded
        self.dirty = dirty
        self.is_image = is_image


class View:
    """One camera/image record backed by a directory."""

    def __init__(self, path: Optional[str] = None):
        self._path: Optional[str] = None
        self._meta: Dict[str, str] = {}
        self._meta_dirty = False
        self._images: Dict[str, _Proxy] = {}
        self._blobs: Dict[str, _Proxy] = {}
        self.camera = CameraInfo()
        if path is not None:
            self.load_view(path)

    # ------------------------------------------------------------------
    # identity / metadata
    # ------------------------------------------------------------------
    @property
    def id(self) -> int:
        return int(self._meta.get("view.id", "-1"))

    @id.setter
    def id(self, value: int) -> None:
        self.set_value("view.id", str(int(value)))

    @property
    def name(self) -> str:
        return self._meta.get("view.name", "")

    @name.setter
    def name(self, value: str) -> None:
        self.set_value("view.name", value)

    def get_value(self, key: str) -> str:
        return self._meta.get(key, "")

    def set_value(self, key: str, value: str) -> None:
        if self._meta.get(key) != value:
            self._meta[key] = value
            self._meta_dirty = True

    def get_directory(self) -> Optional[str]:
        return self._path

    # ------------------------------------------------------------------
    # camera <-> meta.ini (view.cc:380-391, 594-621)
    # ------------------------------------------------------------------
    def set_camera(self, camera: CameraInfo) -> None:
        self.camera = camera.copy()
        self.set_value("camera.focal_length", f"{camera.flen:.10g}")
        self.set_value("camera.radial_distortion", f"{camera.dist[0]:.10g} {camera.dist[1]:.10g}")
        self.set_value("camera.pixel_aspect", f"{camera.paspect:.10g}")
        self.set_value("camera.principal_point", f"{camera.ppoint[0]:.10g} {camera.ppoint[1]:.10g}")
        self.set_value("camera.rotation", " ".join(f"{x:.10g}" for x in camera.rot.reshape(-1)))
        self.set_value("camera.translation", " ".join(f"{x:.10g}" for x in camera.trans))

    def _camera_from_meta(self) -> None:
        cam = CameraInfo()
        if "camera.focal_length" in self._meta:
            cam.flen = float(self._meta["camera.focal_length"])
        if "camera.radial_distortion" in self._meta:
            cam.dist = np.array([float(x) for x in self._meta["camera.radial_distortion"].split()], np.float32)
        if "camera.pixel_aspect" in self._meta:
            cam.paspect = float(self._meta["camera.pixel_aspect"])
        if "camera.principal_point" in self._meta:
            cam.ppoint = np.array([float(x) for x in self._meta["camera.principal_point"].split()], np.float32)
        if "camera.rotation" in self._meta:
            cam.rot = np.array([float(x) for x in self._meta["camera.rotation"].split()], np.float32).reshape(3, 3)
        if "camera.translation" in self._meta:
            cam.trans = np.array([float(x) for x in self._meta["camera.translation"].split()], np.float32)
        self.camera = cam

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------
    def has_image(self, name: str) -> bool:
        return name in self._images

    def has_blob(self, name: str) -> bool:
        return name in self._blobs

    def get_image_names(self):
        return sorted(self._images)

    def get_blob_names(self):
        return sorted(self._blobs)

    def get_image(self, name: str) -> Optional[np.ndarray]:
        proxy = self._images.get(name)
        if proxy is None:
            return None
        if proxy.data is None:
            proxy.data = image_io.load_image(os.path.join(self._path, proxy.filename))
        return proxy.data

    def get_float_image(self, name: str) -> Optional[np.ndarray]:
        img = self.get_image(name)
        if img is None:
            return None
        if img.dtype == np.uint8:
            return img.astype(np.float32) / 255.0
        if img.dtype == np.uint16:
            return img.astype(np.float32) / 65535.0
        return img.astype(np.float32)

    def get_byte_image(self, name: str) -> Optional[np.ndarray]:
        img = self.get_image(name)
        if img is None:
            return None
        if img.dtype == np.uint8:
            return img
        if img.dtype == np.uint16:
            return (img / 257).astype(np.uint8)
        return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def set_original_image(self, image: np.ndarray) -> None:
        """Install the immutable "original" embedding (used only at scene
        creation time by makescene; set_image refuses to touch it)."""
        image = np.asarray(image)
        if image.ndim == 2:
            image = image[:, :, None]
        proxy = _Proxy("original", data=image, dirty=True)
        self._images["original"] = proxy

    def set_image(self, name: str, image: np.ndarray) -> None:
        if name == "original":
            raise ValueError('the "original" embedding is immutable (view.cc set_image)')
        image = np.asarray(image)
        if image.ndim == 2:
            image = image[:, :, None]
        proxy = self._images.get(name)
        if proxy is None:
            proxy = _Proxy(name)
            self._images[name] = proxy
        proxy.data = image
        proxy.dirty = True

    def copy_image_file(self, src: str, dst: str) -> bool:
        """Duplicate embedding `src`'s on-disk file as embedding `dst`
        without a decode/re-encode round trip (identity undistortion in
        sfmrecon writes megabytes of pixels it never touched). Only
        possible when `src` is clean and file-backed; returns False
        otherwise so the caller can fall back to set_image."""
        if dst == "original":
            raise ValueError('the "original" embedding is immutable')
        proxy = self._images.get(src)
        if (proxy is None or proxy.dirty or not proxy.filename
                or not self._path):
            return False
        import shutil

        ext = os.path.splitext(proxy.filename)[1]
        new_fname = dst + ext
        shutil.copyfile(os.path.join(self._path, proxy.filename),
                        os.path.join(self._path, new_fname))
        old = self._images.get(dst)
        if old is not None and old.filename and old.filename != new_fname:
            try:
                os.unlink(os.path.join(self._path, old.filename))
            except FileNotFoundError:
                pass
        self._images[dst] = _Proxy(dst, filename=new_fname)
        return True

    def remove_image(self, name: str) -> bool:
        proxy = self._images.pop(name, None)
        if proxy is None:
            return False
        if proxy.filename and self._path:
            try:
                os.unlink(os.path.join(self._path, proxy.filename))
            except FileNotFoundError:
                pass
        return True

    def get_blob(self, name: str) -> Optional[bytes]:
        proxy = self._blobs.get(name)
        if proxy is None:
            return None
        if proxy.data is None:
            with open(os.path.join(self._path, proxy.filename), "rb") as f:
                proxy.data = f.read()
        return proxy.data

    def set_blob(self, name: str, data: bytes) -> None:
        proxy = self._blobs.get(name)
        if proxy is None:
            proxy = _Proxy(name, is_image=False)
            self._blobs[name] = proxy
        proxy.data = bytes(data)
        proxy.dirty = True

    def remove_blob(self, name: str) -> bool:
        proxy = self._blobs.pop(name, None)
        if proxy is None:
            return False
        if proxy.filename and self._path:
            try:
                os.unlink(os.path.join(self._path, proxy.filename))
            except FileNotFoundError:
                pass
        return True

    def get_image_size(self, name: str):
        """(width, height) of an embedding without decoding pixels when
        possible (MVEI header probe, view.h image proxy width/height)."""
        proxy = self._images.get(name)
        if proxy is None:
            return None
        if proxy.data is not None:
            h, w = proxy.data.shape[:2]
            return w, h
        path = os.path.join(self._path, proxy.filename)
        if proxy.filename.endswith(".mvei"):
            w, h, _, _ = image_io.load_mvei_headers(path)
            return w, h
        from PIL import Image

        with Image.open(path) as img:
            return img.size

    # ------------------------------------------------------------------
    # load / save
    # ------------------------------------------------------------------
    def load_view(self, path: str) -> None:
        path = path.rstrip("/")
        meta_path = os.path.join(path, META_FILE)
        if not os.path.isfile(meta_path):
            raise IOError(f"{path}: not a view directory (missing {META_FILE})")
        self._path = path
        self._meta = parse_ini_file(meta_path)
        self._meta_dirty = False
        self._camera_from_meta()
        self._images.clear()
        self._blobs.clear()
        for fname in sorted(os.listdir(path)):
            if fname == META_FILE or fname.startswith("."):
                continue
            base, ext = os.path.splitext(fname)
            if ext.lower() in _IMAGE_EXTS:
                self._images[base] = _Proxy(base, fname)
            elif ext.lower() == ".blob":
                self._blobs[base] = _Proxy(base, fname, is_image=False)

    def is_dirty(self) -> bool:
        return (
            self._meta_dirty
            or any(p.dirty for p in self._images.values())
            or any(p.dirty for p in self._blobs.values())
        )

    def save_view(self, path: Optional[str] = None) -> None:
        """Write meta.ini and all dirty embeddings (view.cc save path)."""
        if path is not None:
            self._path = path.rstrip("/")
        if self._path is None:
            raise ValueError("view has no directory; pass a path")
        os.makedirs(self._path, exist_ok=True)
        save_ini_file(self._meta, os.path.join(self._path, META_FILE))
        self._meta_dirty = False
        for proxy in self._images.values():
            if not proxy.dirty:
                continue
            img = proxy.data
            # Lossless re-encode policy (view.cc:846): PNG for byte images
            # with <=4 channels, MVEI otherwise.
            use_png = img.dtype == np.uint8 and img.shape[2] <= 4
            new_fname = proxy.name + (".png" if use_png else ".mvei")
            image_io.save_image(img, os.path.join(self._path, new_fname))
            if proxy.filename and proxy.filename != new_fname:
                try:
                    os.unlink(os.path.join(self._path, proxy.filename))
                except FileNotFoundError:
                    pass
            proxy.filename = new_fname
            proxy.dirty = False
        for proxy in self._blobs.values():
            if not proxy.dirty:
                continue
            new_fname = proxy.name + ".blob"
            with open(os.path.join(self._path, new_fname), "wb") as f:
                f.write(proxy.data)
            proxy.filename = new_fname
            proxy.dirty = False

    def save_view_as(self, path: str, original_src: Optional[str] = None) -> None:
        """Create a fresh view dir at `path` and save everything there.

        Unlike save_view, ALL embeddings (not only dirty ones) are written.
        `original_src` optionally copies an original image file verbatim
        (makescene behavior: the "original" embedding keeps its lossy file).
        """
        for proxy in list(self._images.values()) + list(self._blobs.values()):
            if proxy.data is None and self._path is not None:
                if proxy.is_image:
                    proxy.data = image_io.load_image(os.path.join(self._path, proxy.filename))
                else:
                    with open(os.path.join(self._path, proxy.filename), "rb") as f:
                        proxy.data = f.read()
            proxy.dirty = True
            proxy.filename = None
        self._meta_dirty = True
        self._path = path.rstrip("/")
        os.makedirs(self._path, exist_ok=True)
        if original_src is not None:
            ext = os.path.splitext(original_src)[1].lower()
            dst = os.path.join(self._path, "original" + ext)
            shutil.copyfile(original_src, dst)
            self._images["original"] = _Proxy("original", os.path.basename(dst))
        self.save_view()

    def cache_cleanup(self) -> int:
        """Drop loaded, non-dirty embedding data (scene.h cache_cleanup)."""
        released = 0
        for proxy in list(self._images.values()) + list(self._blobs.values()):
            if proxy.data is not None and not proxy.dirty and proxy.filename:
                proxy.data = None
                released += 1
        return released

    @staticmethod
    def create(view_dir: str, view_id: int, name: str = "") -> "View":
        view = View()
        view.id = view_id
        view.name = name or f"view_{view_id:04d}"
        view._path = view_dir
        return view
