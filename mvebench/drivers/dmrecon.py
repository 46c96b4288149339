"""dmrecon -s<level> over a scene the benchmark writes, as a user runs it.

Each call is mve_tpu_torch.apps.dmrecon.reconstruct_views on one chunk of
views (the workload's views_per_call, consecutive view ids), with the
app's default settings and force=True. The window cycles through the
scene's chunks from one drawn from the seed; set-up makes the scene and
warms up with one view of the chunk the window reaches last.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from mvebench.harness import scene as gen
from mvebench.reference import dmrecon as reference


class Driver:
    label_spans = ("bench.call",)

    def __init__(self, workload, config, seed, device, workdir, trace):
        self.w, self.cfg, self.seed, self.device = workload, config, seed, device
        self.scene = os.path.join(workdir, "scene")
        self.extra = {}
        n, k = config["views"], workload["views_per_call"]
        self.chunks = [list(range(i, min(i + k, n))) for i in range(0, n, k)]
        self.start = int(gen.rng_for(seed, 9).integers(len(self.chunks)))

    def setup(self):
        from mve_tpu_torch.apps import dmrecon

        self.app = dmrecon
        self.cams = gen.write_scene(self.scene, self.cfg, self.seed, torch, self.device)
        warm = self.chunks[(self.start - 1) % len(self.chunks)][:1]
        self.app.reconstruct_views(self.scene, scale=self.w["level"], view_ids=set(warm),
                                   force=True, verbose=False, device=self.device)

    def specs(self):
        n = len(self.chunks)
        for i in itertools.count():
            yield tuple(self.chunks[(self.start + i) % n])

    def call(self, views):
        from mve_tpu_torch.mvs import dmrecon as mvs

        n = self.app.reconstruct_views(self.scene, scale=self.w["level"], view_ids=set(views),
                                       force=True, verbose=False, device=self.device)
        t = mvs.LAST_TIMINGS
        return n, {"views": n, "prepare_ms": t.get("prepare_ms", 0.0),
                   "solve_ms": t.get("solve_ms", 0.0), "write_ms": t.get("write_ms", 0.0)}

    def release(self):
        from mve_tpu_torch.mvs.pyramid import ImagePyramidCache

        ImagePyramidCache.cleanup()

    def judge(self, calls):
        return reference.judge(self.scene, self.cams, self.cfg, self.w, self.due(calls))

    def control(self, calls):
        """The check with the control's maps in the program's place."""
        w, h = gen.level_dims(self.cfg["width"], self.cfg["height"], self.w["level"])
        maps = {}
        for v in self.due(calls):
            depth = reference.z_depth_control(self.cams[v], w, h)
            maps[v] = (depth, np.ones_like(depth))
        return reference.judge(self.scene, self.cams, self.cfg, self.w, self.due(calls), maps)

    @staticmethod
    def due(calls):
        return sorted({v for c in calls for v in c.spec})
