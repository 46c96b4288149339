"""Scene: a directory of views (reference: libs/mve/scene.h/.cc).

Layout on disk (scene.h:34-100):

    <scene>/
      views/
        view_0000.mve/   (View directories, see view.py)
        view_0001.mve/
        ...
      synth_0.out        (MVE bundle, lazy-loaded)

Views are ordered and addressed by their meta.ini id; save_views writes
only dirty views and cache_cleanup releases loaded image data. The bundle
is loaded on first use and written by save_bundle (or save_scene when it
is dirty).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from .bundle import Bundle
from . import bundle_io
from .view import View

VIEWS_DIR = "views"
BUNDLE_FILE = "synth_0.out"
_VIEW_DIR_RE = re.compile(r"^view_(\d+)\.mve$")


class Scene:
    def __init__(self, path: Optional[str] = None):
        self._path: Optional[str] = None
        self.views: List[Optional[View]] = []
        self._bundle: Optional[Bundle] = None
        self._bundle_dirty = False
        if path is not None:
            self.load_scene(path)

    @property
    def path(self) -> Optional[str]:
        return self._path

    def get_views(self) -> List[Optional[View]]:
        return self.views

    def get_view_by_id(self, view_id: int) -> Optional[View]:
        if 0 <= view_id < len(self.views):
            return self.views[view_id]
        return None

    def load_scene(self, path: str) -> None:
        """Scan views/ and register one View per directory (scene.cc
        init_views). The view list is indexed by view id; gaps are None."""
        path = path.rstrip("/")
        views_path = os.path.join(path, VIEWS_DIR)
        if not os.path.isdir(views_path):
            raise IOError(f"{path}: not a scene directory (missing {VIEWS_DIR}/)")
        self._path = path
        loaded = []
        for entry in sorted(os.listdir(views_path)):
            if _VIEW_DIR_RE.match(entry) or entry.endswith(".mve"):
                vdir = os.path.join(views_path, entry)
                if os.path.isdir(vdir):
                    loaded.append(View(vdir))
        max_id = max((v.id for v in loaded), default=-1)
        self.views = [None] * (max_id + 1)
        for v in loaded:
            if v.id < 0:
                raise IOError(f"view at {v.get_directory()} has invalid id")
            if self.views[v.id] is not None:
                raise IOError(f"duplicate view id {v.id}")
            self.views[v.id] = v
        self._bundle = None
        self._bundle_dirty = False

    @staticmethod
    def create(path: str) -> "Scene":
        """Create an empty scene directory (scene.h Scene::create)."""
        os.makedirs(os.path.join(path, VIEWS_DIR), exist_ok=True)
        scene = Scene()
        scene._path = path.rstrip("/")
        return scene

    def get_bundle(self) -> Bundle:
        """Lazy-load synth_0.out (scene.h:64-74)."""
        if self._bundle is None:
            bundle_path = os.path.join(self._path, BUNDLE_FILE)
            if not os.path.isfile(bundle_path):
                raise IOError(f"{bundle_path}: no bundle in scene")
            self._bundle = bundle_io.load_mve_bundle(bundle_path)
        return self._bundle

    def has_bundle(self) -> bool:
        return self._bundle is not None or os.path.isfile(os.path.join(self._path, BUNDLE_FILE))

    def set_bundle(self, bundle: Bundle) -> None:
        self._bundle = bundle
        self._bundle_dirty = True

    def save_bundle(self) -> None:
        if self._bundle is not None:
            bundle_io.save_mve_bundle(self._bundle, os.path.join(self._path, BUNDLE_FILE))
            self._bundle_dirty = False

    def add_view(self, view: View) -> None:
        """Register a view; its directory is assigned from its id."""
        while len(self.views) <= view.id:
            self.views.append(None)
        self.views[view.id] = view

    def view_dir_for_id(self, view_id: int) -> str:
        return os.path.join(self._path, VIEWS_DIR, f"view_{view_id:04d}.mve")

    def save_views(self) -> None:
        """Save all dirty views (scene.cc save_views)."""
        for view in self.views:
            if view is not None and view.is_dirty():
                view.save_view(view.get_directory() or self.view_dir_for_id(view.id))

    def save_scene(self) -> None:
        if self._bundle_dirty:
            self.save_bundle()
        self.save_views()

    def is_dirty(self) -> bool:
        return self._bundle_dirty or any(v is not None and v.is_dirty() for v in self.views)

    def cache_cleanup(self) -> int:
        return sum(v.cache_cleanup() for v in self.views if v is not None)

    def get_total_mem_usage(self) -> int:
        """Approximate bytes held by loaded embeddings and the bundle
        (scene.h memory accounting)."""
        total = 0
        for view in self.views:
            if view is None:
                continue
            for proxy in list(view._images.values()) + list(view._blobs.values()):
                if proxy.data is not None:
                    total += (proxy.data.nbytes if hasattr(proxy.data, "nbytes")
                              else len(proxy.data))
        if self._bundle is not None:
            total += self._bundle.get_byte_size()
        return total
