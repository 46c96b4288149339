"""fssrecon with default flags over point sets the benchmark writes.

Set-up writes one point set per view (harness.scene.point_set: the true
depth map at the workload's level with seeded noise, through
scene2pset -F2's arithmetic) and warms up with one call. Each call is
mve_tpu_torch.apps.fssrecon.fssr_reconstruct over the PLYs of the
configuration's fssrecon_views_per_call consecutive views, writing its
own surface; the window cycles through the disjoint groups from one
drawn from the seed.

The evaluation's inputs and outputs are observed where the program hands
them on: block_eval.evaluate_positions_blocked is wrapped so that each
call keeps the sums at a sample of its corners (drawn from the seed) and
every corner it evaluated, for the check and, in a traced run, for the
roofline's count.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mvebench.harness import scene as gen
from mvebench.reference import fssrecon as reference


class Driver:
    label_spans = ("fssr.block_eval", "bench.call")

    def __init__(self, workload, config, seed, device, workdir, trace):
        self.w, self.cfg, self.seed, self.device, self.trace = workload, config, seed, device, trace
        self.dir = workdir
        # Groups of k consecutive views, k the configuration's
        # fssrecon_views_per_call (all its views where it has none); the
        # first views (the central view of the ring, where the count leaves
        # views over) are left out.
        n = config["views"]
        k = config.get("fssrecon_views_per_call", n)
        self.groups = [tuple(range(i, i + k)) for i in range(n % k, n, k)]
        self.start = int(gen.rng_for(seed, 9).integers(len(self.groups)))
        self.extra = {}
        self.observed = []          # per call: (checked corners, sums there, every corner)
        self.n_calls = 0

    def ply(self, v):
        return os.path.join(self.dir, f"pset-{v:04d}.ply")

    def surface(self, i):
        return os.path.join(self.dir, f"surf-{i:04d}.ply")

    def setup(self):
        from mve_tpu_torch.apps import fssrecon
        from mve_tpu_torch.fssr import block_eval

        self.app, self.block_eval = fssrecon, block_eval
        self.cams = gen.make_cameras(self.cfg["views"], gen.rng_for(self.seed, 0))
        textures = gen.textures_for(self.seed, self.cfg.get("texture_size", gen.TEXTURE_SIZE))
        w, h = gen.level_dims(self.cfg["width"], self.cfg["height"], self.w["level"])
        p = self.w["point_set"]

        def make(v):
            ps = gen.point_set(self.cams[v], textures, w, h, p["depth_noise"], p["dd_factor"],
                               p["scale_factor"], p["conf_rings"], gen.rng_for(self.seed, 4, v),
                               torch, self.device)
            gen.write_point_set(self.ply(v), ps)
            return v, ps

        views = sorted({v for g in self.groups for v in g})
        with ThreadPoolExecutor(gen.WRITER_THREADS) as pool:
            self.samples = dict(pool.map(make, views))
        self.real_eval = block_eval.evaluate_positions_blocked
        block_eval.evaluate_positions_blocked = self._observed_eval
        warm = self.groups[(self.start - 1) % len(self.groups)]
        self.app.fssr_reconstruct([self.ply(v) for v in warm], self.surface(9999),
                                  verbose=False, device=self.device)
        self.observed.clear()
        os.unlink(self.surface(9999))

    def _observed_eval(self, samples, positions, *args, **kwargs):
        sums = self.real_eval(samples, positions, *args, **kwargs)
        rng = gen.rng_for(self.seed, 10, len(self.observed))
        idx = np.unique(rng.integers(0, len(positions), self.w["checked_corners"]))
        # Every corner is kept (not copied) for the check of the octree's
        # resolution and, in a traced run, for the roofline's count.
        self.observed.append((np.array(positions[idx], np.float64), sums[idx].copy(), positions))
        return sums

    def specs(self):
        n = len(self.groups)
        for i in itertools.count():
            yield self.groups[(self.start + i) % n]

    def call(self, group):
        out = self.surface(self.n_calls)
        self.n_calls += 1
        self.app.fssr_reconstruct([self.ply(v) for v in group], out, verbose=False,
                                  device=self.device)
        st, be = self.app.LAST_STATS, self.block_eval.STATS
        n = sum(len(self.samples[v]["pos"]) for v in group)
        return n, {"samples": n, "octree_ms": st.get("octree_ms", 0),
                   "extract_ms": st.get("extract_ms", 0), "eval_ms": st.get("eval_ms", 0),
                   "expand_ms": be.get("expand_ms", 0.0), "dispatch_ms": be.get("dispatch_ms", 0.0),
                   "sync_ms": be.get("sync_ms", 0.0)}

    def release(self):
        """Unwraps the evaluation; a traced run's calls are handed to the
        metric readers as (samples, corner positions) each."""
        self.block_eval.evaluate_positions_blocked = self.real_eval
        if self.trace:
            n = len(self.groups)
            self.extra["calls"] = [(reference.clean(self.samples, self.groups[(self.start + i) % n]),
                                    corners) for i, (_, _, corners) in enumerate(self.observed)]

    def judge(self, calls, observed=None):
        observed = self.observed if observed is None else observed
        return reference.judge(self.samples, self.cams, self.w,
                               [(c.spec, self.surface(i), observed[i]) for i, c in enumerate(calls)])

    def control(self, calls):
        """The check with the control's sums in the program's place at the
        same corners (the surfaces stay the program's)."""
        observed = [(pos, reference.sums_at(reference.clean(self.samples, c.spec), pos,
                                            torch.bfloat16)[0], corners)
                    for c, (pos, _, corners) in zip(calls, self.observed)]
        return self.judge(calls, observed)
