"""dmrecon: per-view MVS depth maps (reference: apps/dmrecon/dmrecon.cc;
port of mve_tpu/apps/dmrecon.py).

Runs the MVS solver for all (or selected) views at pyramid level -s;
skips views whose depth embedding already exists unless --force.

    python -m mve_tpu_torch.apps.dmrecon -s2 [--device cpu] <scene>

--process-id and --num-processes split the views modulo the process
count; as in mve_tpu, their defaults come from JAX_PROCESS_ID and
JAX_NUM_PROCESSES (0 and 1 when unset).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

from .. import resolve_device
from ..core import Scene
from ..mvs import DMRecon, Settings
from ..parallel.multihost import num_processes_from_env, process_id_from_env
from ..utils.timer import WallTimer
from ..utils.tracing import span

# Per-run stats (mean depth-map fill ratio etc.) recorded by
# reconstruct_views — the analog of the reference's per-view fill
# printout (libs/dmrecon/dmrecon.cc:149-157).
LAST_STATS: dict = {}


class FancyProgressPrinter:
    """Live single-line status poller (reference:
    apps/dmrecon/fancy_progress_printer.h). A daemon thread polls the
    current DMRecon's ``progress`` struct and rewrites the status line
    (``\\r``) while a view reconstructs; silent when stdout is not a
    terminal."""

    def __init__(self, interval: float = 0.5):
        self.interval = interval
        self._recon = None
        self._view_id = -1
        self._thread = None
        self._stop = False

    def attach(self, view_id: int, recon: "DMRecon") -> None:
        import threading

        self._view_id = view_id
        self._recon = recon
        if self._thread is None and sys.stdout.isatty():
            self._stop = False
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def detach(self) -> None:
        self._recon = None

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None
            sys.stdout.write("\r\033[K")
            sys.stdout.flush()

    def _run(self) -> None:
        import time

        while not self._stop:
            recon = self._recon
            if recon is not None:
                pr = recon.progress
                line = (f"\r\033[Kview {self._view_id}: {pr.status.value}"
                        f" ({pr.elapsed():.1f}s")
                if pr.queue_size:
                    line += f", {pr.queue_size} rounds left"
                line += ")"
                sys.stdout.write(line)
                sys.stdout.flush()
            time.sleep(self.interval)


@span("dmrecon.call")
def reconstruct_views(scene_path: str, *, scale: int = 0, view_ids=None,
                      max_pixels: int = 0, force: bool = False,
                      settings: Settings | None = None,
                      process_id: int = 0, num_processes: int = 1,
                      verbose: bool = True,
                      progress: "FancyProgressPrinter | None" = None,
                      device="cuda") -> int:
    """Batched MVS over views; with num_processes > 1, views partition
    across processes by view id modulo the count (per-view artifacts on
    shared storage make this restartable and embarrassingly parallel).

    Returns the number of depth maps written. The call is a
    dmrecon.call span (utils/tracing.py), its stages spans inside it."""
    from ..mvs.dmrecon import reconstruct_batch

    dev = resolve_device(device)
    with span("dmrecon.scene_open"):
        scene = Scene(scene_path)
        views = scene.get_views()
        base = settings or Settings()
        todo = []
        for i, view in enumerate(views):
            if view is None or not view.camera.valid:
                continue
            if view_ids is not None and i not in view_ids:
                continue
            if num_processes > 1 and i % num_processes != process_id:
                continue
            s = scale
            if max_pixels > 0 and view.has_image(base.image_embedding):
                w, h = view.get_image_size(base.image_embedding)
                s = 0
                while (w >> s) * (h >> s) > max_pixels:
                    s += 1
            if not force and view.has_image(f"depth-L{s}"):
                if verbose:
                    print(f"View {i}: depth-L{s} exists, skipping.")
                continue
            todo.append((i, s))
    if not todo:
        return 0
    timer = WallTimer()
    results = reconstruct_batch(scene, base, todo, verbose=verbose, device=dev)
    for vid in results:
        with span("dmrecon.save"):
            views[vid].save_view()
            views[vid].cache_cleanup()
    LAST_STATS.clear()
    if results:
        fills = list(results.values())
        LAST_STATS["depth_fill"] = float(np.mean(fills))
        LAST_STATS["depth_fill_min"] = float(np.min(fills))
        LAST_STATS["per_view_fills"] = {
            int(v): float(f) for v, f in sorted(results.items())}
        if 0 in results:
            LAST_STATS["depth_fill_view0"] = float(results[0])
    if verbose:
        print(f"MVS took {timer.get_elapsed()}ms for {len(results)} views.")
    return len(results)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dmrecon", description="Multi-view stereo.")
    p.add_argument("scene", help="Scene directory")
    p.add_argument("-s", "--scale", type=int, default=0, help="Pyramid level")
    p.add_argument("--max-pixels", type=int, default=0,
                   help="Select scale so images are below ARG pixels")
    p.add_argument("--view-ids", "-l", "--list-view", type=str, default="",
                   dest="view_ids",
                   help="Comma-separated view IDs to reconstruct [all]")
    p.add_argument("-m", "--master-view", type=int, default=-1,
                   help="Reconstruct only this view ID")
    p.add_argument("-n", "--neighbors", type=int, default=None,
                   help="Amount of neighbor views (global view selection) [20]")
    p.add_argument("--local-neighbors", type=int, default=None,
                   help="Amount of neighbors for local view selection [4]")
    p.add_argument("-f", "--filter-width", type=int, default=None,
                   help="NCC patch size [5]")
    p.add_argument("--min-ncc", type=float, default=None,
                   help="Minimum NCC for a view to count [0.3]")
    p.add_argument("-i", "--image", type=str, default=None,
                   help="Image embedding [undistorted]")
    p.add_argument("--nocolorscale", action="store_true",
                   help="Accepted for reference CLI parity; NCC scoring is "
                        "affine-intensity invariant, so color scaling is "
                        "always implicitly on and cannot be disabled")
    p.add_argument("--keep-dz", action="store_true",
                   help="Store dz map as dz-L<s> [on]")
    p.add_argument("--keep-conf", action="store_true",
                   help="Store confidence map as conf-L<s> [on]")
    p.add_argument("-p", "--writeply", action="store_true",
                   help="Write per-view reconstruction as PLY")
    p.add_argument("--plydest", type=str, default="recon",
                   help="Destination directory for PLY files")
    p.add_argument("--bounding-box", type=str, default="",
                   help="Six comma-separated values: minx,miny,minz,maxx,maxy,maxz")
    p.add_argument("--force", action="store_true",
                   help="Reconstruct even if depth embedding exists")
    p.add_argument("--process-id", type=int, default=process_id_from_env(),
                   help="This process's index for sharding the views "
                        "[JAX_PROCESS_ID or 0]")
    p.add_argument("--num-processes", type=int, default=num_processes_from_env(),
                   help="Total processes sharing the view list "
                        "[JAX_NUM_PROCESSES or 1]")
    p.add_argument("--progress", nargs="?", const="fancy", default="simple",
                   choices=("silent", "simple", "fancy"),
                   help="Progress output style: silent, simple or fancy")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu")
    args = p.parse_args(argv)
    ids = None
    if args.view_ids:
        ids = set(int(x) for x in args.view_ids.split(","))
    if args.master_view >= 0:
        ids = {args.master_view}
    if args.nocolorscale:
        print("Note: NCC scoring normalizes intensity per patch; "
              "--nocolorscale has no effect in this implementation.")

    st = Settings()
    overrides = {}
    if args.neighbors is not None:
        overrides["global_vs_max"] = args.neighbors
    if args.local_neighbors is not None:
        overrides["nr_recon_neighbors"] = args.local_neighbors
    if args.filter_width is not None:
        overrides["filter_width"] = args.filter_width
    if args.min_ncc is not None:
        overrides["min_ncc"] = args.min_ncc
    if args.image is not None:
        overrides["image_embedding"] = args.image
    if args.writeply:
        overrides["write_ply_file"] = True
        overrides["ply_path"] = os.path.join(args.scene, args.plydest)
    if args.bounding_box:
        vals = [float(x) for x in args.bounding_box.split(",")]
        if len(vals) != 6:
            p.error("--bounding-box needs 6 comma-separated values")
        overrides["aabb_min"] = np.asarray(vals[:3])
        overrides["aabb_max"] = np.asarray(vals[3:])
    if overrides:
        st = dataclasses.replace(st, **overrides)
    printer = FancyProgressPrinter() if args.progress == "fancy" else None
    if args.progress == "silent":
        st = dataclasses.replace(st, quiet=True)
    try:
        n = reconstruct_views(args.scene, scale=args.scale, view_ids=ids,
                              max_pixels=args.max_pixels, force=args.force,
                              settings=st,
                              process_id=args.process_id,
                              num_processes=args.num_processes,
                              verbose=args.progress != "silent",
                              progress=printer, device=args.device)
    finally:
        if printer is not None:
            printer.stop()
    print(f"Reconstructed {n} depth maps.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
