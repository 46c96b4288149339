"""dmrecon -s<level> over the benchmark's street (forward motion), as a
user runs it on a drive.

The loop is drivers/dmrecon.py's, reused: each call is
mve_tpu_torch.apps.dmrecon.reconstruct_views on one chunk of consecutive
frames (the workload's views_per_call) with the app's default settings
and force=True, cycling the chunks from one drawn from the seed; set-up
writes the street (harness/street.py) and warms up with one view of the
chunk the window reaches last. Only the frames between the
configuration's lead_frames at either end are reconstructed, so every
frame a call reconstructs has the frames it shares points with on both
sides (a stretch too short for them, as the tests' small scenes are,
keeps at least one frame to reconstruct). The check is
reference/dmrecon_street's.
A call's counters also carry its views by the solver they took
(views_warp, views_sweep), from the program's LAST_TIMINGS["batches"].
"""

from __future__ import annotations

import numpy as np
import torch

from mvebench.harness import scene as gen
from mvebench.harness import street
from mvebench.harness.bench import load_module
from mvebench.reference import dmrecon_street as reference

_base = load_module("drivers", "dmrecon")


class Driver(_base.Driver):

    def __init__(self, workload, config, seed, device, workdir, trace):
        super().__init__(workload, config, seed, device, workdir, trace)
        lead = min(config["lead_frames"], (config["views"] - 1) // 2)
        k = workload["views_per_call"]
        last = config["views"] - lead
        self.chunks = [list(range(i, min(i + k, last))) for i in range(lead, last, k)]
        self.start = int(gen.rng_for(seed, 9).integers(len(self.chunks)))

    def setup(self):
        from mve_tpu_torch.apps import dmrecon

        self.app = dmrecon
        self.cams = street.write_scene(self.scene, self.cfg, self.seed, torch, self.device)
        warm = self.chunks[(self.start - 1) % len(self.chunks)][:1]
        self.app.reconstruct_views(self.scene, scale=self.w["level"], view_ids=set(warm),
                                   force=True, verbose=False, device=self.device)

    def call(self, views):
        from mve_tpu_torch.mvs import dmrecon as mvs

        n, counters = super().call(views)
        for solver in ("warp", "sweep"):
            counters[f"views_{solver}"] = sum(b[0] for b in mvs.LAST_TIMINGS.get("batches", [])
                                              if b[1] == solver)
        return n, counters

    def judge(self, calls):
        return reference.judge(self.scene, self.cams, self.cfg, self.w, self.due(calls),
                               device=self.device)

    def control(self, calls):
        """The check with the control's maps in the program's place."""
        w, h = gen.level_dims(self.cfg["width"], self.cfg["height"], self.w["level"])
        maps = {}
        for v in self.due(calls):
            depth = reference.z_depth_control(self.cams, v, w, h, self.device)
            maps[v] = (depth, np.ones_like(depth))
        return reference.judge(self.scene, self.cams, self.cfg, self.w, self.due(calls), maps,
                               device=self.device)
