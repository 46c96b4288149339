"""dmrecon --max-pixels over the benchmark's community photo collection
(harness/collection.py), as a user runs it on photos of many cameras.

The loop is drivers/dmrecon.py's, reused: each call is
mve_tpu_torch.apps.dmrecon.reconstruct_views on one chunk of consecutive
views (the workload's views_per_call) with the workload's max_pixels, the
app's other defaults and force=True, cycling the chunks from one drawn
from the seed; set-up writes the collection and warms up with one view
of the chunk the window reaches last. Each view is reconstructed at its
own level, so a call solves views of several shapes. The check is
reference/dmrecon_collection's. A call's counters also carry its views
by the solver they took (views_warp, views_sweep), from the program's
LAST_TIMINGS["batches"].
"""

from __future__ import annotations

import numpy as np
import torch

from mvebench.harness import collection
from mvebench.harness.bench import load_module
from mvebench.reference import dmrecon_collection as reference

_base = load_module("drivers", "dmrecon")


class Driver(_base.Driver):

    def setup(self):
        from mve_tpu_torch.apps import dmrecon

        self.app = dmrecon
        self.cams = collection.write_scene(self.scene, self.cfg, self.seed, torch, self.device)
        warm = self.chunks[(self.start - 1) % len(self.chunks)][:1]
        self.app.reconstruct_views(self.scene, max_pixels=self.w["max_pixels"],
                                   view_ids=set(warm), force=True, verbose=False,
                                   device=self.device)

    def call(self, views):
        from mve_tpu_torch.mvs import dmrecon as mvs

        n = self.app.reconstruct_views(self.scene, max_pixels=self.w["max_pixels"],
                                       view_ids=set(views), force=True, verbose=False,
                                       device=self.device)
        t = mvs.LAST_TIMINGS
        counters = {"views": n, "prepare_ms": t.get("prepare_ms", 0.0),
                    "solve_ms": t.get("solve_ms", 0.0), "write_ms": t.get("write_ms", 0.0)}
        for solver in ("warp", "sweep"):
            counters[f"views_{solver}"] = sum(b[0] for b in t.get("batches", [])
                                              if b[1] == solver)
        return n, counters

    def judge(self, calls):
        return reference.judge(self.scene, self.cams, self.cfg, self.w, self.due(calls),
                               device=self.device)

    def control(self, calls):
        """The check with the control's maps in the program's place."""
        at = reference.levels(self.cfg, self.w["max_pixels"])
        maps = {}
        for v in self.due(calls):
            _, w, h = at[v]
            depth = reference.z_depth_control(self.cams[v], w, h, self.device)
            maps[v] = (depth, np.ones_like(depth))
        return reference.judge(self.scene, self.cams, self.cfg, self.w, self.due(calls), maps,
                               device=self.device)
