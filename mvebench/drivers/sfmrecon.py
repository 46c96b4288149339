"""sfmrecon --skip-sfm over a scene the benchmark writes, as a user runs it.

Each call is mve_tpu_torch.apps.sfmrecon.sfm_reconstruct(scene,
skip_sfm=True) with the app's default settings (the workload file's
`app` names them; those the function takes are passed): a fresh Scene,
every view's image decoded, SIFT and SURF on the card, all-pairs
matching with the low-res prefilter and RANSAC, and prebundle.sfm
written. A call's work is the V (V - 1) / 2 pairs of views it matches.
When the app returns, the call moves its prebundle aside for the check,
so that the next call computes a new one. Set-up writes the scene and
makes one warm call.

In a traced run the benchmark opens spans of its own around the calls
into each stage of the program (bench.sfm.*), and observes the inputs
of the three top-2 passes (the low-res prefilter, SIFT, SURF: each
view's descriptor count and the pairs matched), from which
harness/sfm_work.py counts the work those passes need. An untraced run
wraps nothing. The probes hold the program to the shape they assume:
each wrapped function has to exist (the matcher's with the arguments
read), and after every call each span has to have opened as often as
the call's views and passes say; otherwise the run fails, rather than
its readers going silent or filing work under the wrong pass. They stand
in for spans of the program's own, which sfmrecon does not have yet.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import itertools
import os

import torch

from mvebench.harness import scene as gen
from mvebench.harness import sfm_work
from mvebench.reference import sfmrecon as reference

MATCH_PASSES = ("lowres", "sift", "surf")


class Probes:
    """The benchmark's spans around the program's stages, and the inputs
    of its top-2 passes; install() wraps, check() holds a call to the
    spans it should have opened, remove() restores."""

    #: The spans opened once a view, and once a call, by every call.
    PER_VIEW = ("bench.sfm.load_image", "bench.sfm.resize")
    PER_CALL = ("bench.sfm.sift", "bench.sfm.surf", "bench.sfm.matching",
                "bench.sfm.ransac.solve", "bench.sfm.prebundle_write")
    #: The arguments of _match_pairs that the probe reads, in order.
    MATCH_ARGS = ("desc", "n_desc", "pair_a", "pair_b")

    def __init__(self, device, lowres: int | None):
        """lowres: the low-res prefilter's feature count, None where it is off."""
        self.device, self.lowres = device, lowres
        self.passes = []            # this call's (pass, ops, bytes)
        self.opened = collections.Counter()   # this call's spans
        self.saved = []             # (owner, attribute, original)

    def _wrap(self, owner, attr, make):
        real = getattr(owner, attr, None)
        if not callable(real):
            raise RuntimeError(f"sfmrecon probe: {owner.__name__}.{attr} is gone; the "
                               "benchmark's spans no longer fit the program")
        self.saved.append((owner, attr, real))
        setattr(owner, attr, make(real))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, owner, attr, name, sync=False):
        def make(real):
            def spanned(*args, **kwargs):
                self.opened[name] += 1
                with torch.profiler.record_function(name):
                    out = real(*args, **kwargs)
                    if sync:
                        self._sync()
                return out
            return spanned
        self._wrap(owner, attr, make)

    def install(self):
        from mve_tpu_torch.apps import sfmrecon
        from mve_tpu_torch.core import view
        from mve_tpu_torch.sfm import sift, surf
        from mve_tpu_torch.sfm.bundler import features, matching_batched

        args = tuple(inspect.signature(matching_batched._match_pairs).parameters)
        if args[:len(self.MATCH_ARGS)] != self.MATCH_ARGS:
            raise RuntimeError(f"sfmrecon probe: _match_pairs takes {args}, not "
                               f"{self.MATCH_ARGS} first; its work can no longer be read")
        self._span(view.View, "get_image", "bench.sfm.load_image")
        self._span(features.Features, "_limit_size", "bench.sfm.resize")
        self._span(sift, "detect_and_describe_batch", "bench.sfm.sift")
        self._span(surf, "detect_and_describe_batch", "bench.sfm.surf")
        self._span(matching_batched.BatchedMatching, "compute", "bench.sfm.matching")
        self._span(matching_batched, "_ransac_pairs", "bench.sfm.ransac.solve", sync=True)
        self._span(sfmrecon, "save_prebundle", "bench.sfm.prebundle_write")
        self._wrap(matching_batched, "_match_pairs", self._observed_match)

    def _observed_match(self, real):
        """A top-2 pass in a span named after it (SURF's descriptors are 64
        wide; of the 128-wide passes the first is the low-res prefilter
        where it is on), closed once the device has finished; then its
        inputs' work."""
        def match_pairs(desc, n_desc, pair_a, pair_b, *args, **kwargs):
            dim = int(desc.shape[-1])
            wide = sum(1 for p in self.passes if p[0] != "surf")
            name = "surf" if dim == 64 else ("lowres" if self.lowres and not wide else "sift")
            if name == "lowres" and desc.shape[1] > self.lowres:
                raise RuntimeError(f"sfmrecon probe: the first 128-wide pass holds "
                                   f"{desc.shape[1]} descriptors a view, more than the "
                                   f"low-res prefilter's {self.lowres}")
            self.opened[f"bench.sfm.match.{name}"] += 1
            with torch.profiler.record_function(f"bench.sfm.match.{name}"):
                out = real(desc, n_desc, pair_a, pair_b, *args, **kwargs)
                self._sync()
            ops, nbytes = sfm_work.pass_work(n_desc.tolist(), pair_a.tolist(), pair_b.tolist(),
                                             dim)
            self.passes.append((name, ops, nbytes))
            return out
        return match_pairs

    def begin(self):
        self.passes, self.opened = [], collections.Counter()

    def check(self, views: int):
        """Fail the run unless this call opened each span as often as a
        call over `views` views does, and ran the top-2 passes in order."""
        want = dict.fromkeys(self.PER_VIEW, views) | dict.fromkeys(self.PER_CALL, 1)
        got = {name: self.opened[name] for name in want}
        order = [p[0] for p in self.passes]
        want_order = (["lowres"] if self.lowres else []) + ["sift", "surf"]
        if got != want or order != want_order:
            raise RuntimeError(f"sfmrecon probe: a call opened {got} and ran the passes "
                               f"{order}, where {views} views give {want} and {want_order}; "
                               "the benchmark's spans no longer fit the program")

    def remove(self):
        for owner, attr, real in reversed(self.saved):
            setattr(owner, attr, real)
        self.saved.clear()


class Driver:
    label_spans = ("bench.call", "bench.sfm.load_image", "bench.sfm.resize", "bench.sfm.sift",
                   "bench.sfm.surf", "bench.sfm.matching", "bench.sfm.ransac.solve",
                   "bench.sfm.prebundle_write") + tuple(f"bench.sfm.match.{p}"
                                                        for p in MATCH_PASSES)

    def __init__(self, workload, config, seed, device, workdir, trace):
        self.w, self.cfg, self.seed, self.device = workload, config, seed, device
        self.scene = os.path.join(workdir, "scene")
        self.aside = os.path.join(workdir, "prebundles")
        self.prebundle = os.path.join(self.scene, "prebundle.sfm")
        self.pairs = config["views"] * (config["views"] - 1) // 2
        app = workload["app"]
        lowres = app["num_lowres_features"] if app["use_lowres_matching"] else None
        self.probes = Probes(device, lowres) if trace else None
        self.extra = {}
        self.paths = []             # each call's prebundle, moved aside

    def setup(self):
        from mve_tpu_torch.apps import sfmrecon

        self.app = sfmrecon
        self.cams = gen.write_scene(self.scene, self.cfg, self.seed, torch, self.device)
        os.makedirs(self.aside)
        if self.probes is not None:
            self.probes.install()
        self._run()
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.prebundle)

    def _run(self):
        app = self.w["app"]
        if self.probes is not None:
            self.probes.begin()
        self.app.sfm_reconstruct(self.scene, skip_sfm=True, max_pixels=app["max_pixels"],
                                 use_lowres_matching=app["use_lowres_matching"],
                                 verbose=False, device=self.device)
        if self.probes is not None:
            self.probes.check(self.cfg["views"])

    def specs(self):
        return itertools.count()

    def call(self, k):
        self._run()
        path = os.path.join(self.aside, f"{k:05d}.sfm")
        with contextlib.suppress(FileNotFoundError):
            os.replace(self.prebundle, path)
        self.paths.append(path)
        t = self.app.LAST_TIMINGS
        counters = {"pairs": self.pairs, "views": self.cfg["views"]}
        for key in ("features_ms", "matching_ms", "ransac_sample_ms", "ransac_ms",
                    "n_features", "n_lowres_pairs", "n_ransac_pairs", "n_connected_pairs"):
            if key in t:
                counters[key] = t[key]
        if self.probes is not None:
            counters["top2"] = [list(p) for p in self.probes.passes]
        return self.pairs, counters

    def release(self):
        if self.probes is not None:
            self.probes.remove()

    def judge(self, calls):
        return reference.judge(self.cams, self.cfg, self.w, self.paths[:len(calls)])

    def control(self, calls):
        """The check with the control's matches in the program's place."""
        return reference.judge(self.cams, self.cfg, self.w, self.paths[:len(calls)],
                               reference.epipolar_control(self.cams, self.cfg, self.w))
