"""Per-view depth map reconstruction (reference: libs/dmrecon/dmrecon.cc).

Pipeline per reference view (same stages as DMRecon::start, :90-145):
  analyze features -> global view selection -> dense initialization from
  sparse features -> on-device optimization (plane sweep + local view
  selection + PatchMatch propagation + parabolic refinement +
  slanted-plane rounds; replaces sequential region growing,
  dmrecon.cc:334-434) -> write depth-L<s>/conf-L<s>/dz-L<s>/undist-L<s>
  embeddings with ray-length depths.

Host preparation is numpy, as in mve_tpu. `_run_batch` moves a batch's
arrays to the device once, runs the solver (sweep_solver.py, or the warp
solver in solver.py for views whose pairs do not rectify) and reads the
results back once.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import image_tools
from ..core.scene import Scene
from ..utils.tracing import count, read_device_times, span
from .pyramid import ImagePyramidCache, _to_gray, half_size_gaussian_np
from .settings import Settings
from .view_selection import global_view_selection

# Per-run wall times of reconstruct_batch's stages, in ms (host
# preparation, device solve up to the read-back, writes: the intervals of
# the mvs.prepare span, the mvs.solve spans and the mvs.write spans), and
# the solver calls made. Read by chip_smoke.py and the benchmark.
LAST_TIMINGS: dict = {}


def _level_dims(w: int, h: int, level: int):
    for _ in range(level):
        w = (w + 1) >> 1
        h = (h + 1) >> 1
    return w, h


def _fill_sparse(depth_sparse: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Dense completion of sparse seeds: pyramid downsample (valid mean)
    then coarse-to-fine fill of holes."""
    levels = [(depth_sparse, mask.astype(np.float64))]
    d, m = depth_sparse, mask.astype(np.float64)
    while d.shape[0] > 2 and d.shape[1] > 2:
        dpad = np.pad(d * m, ((0, d.shape[0] % 2), (0, d.shape[1] % 2)))
        mpad = np.pad(m, ((0, d.shape[0] % 2), (0, d.shape[1] % 2)))
        ds = dpad[0::2, 0::2] + dpad[1::2, 0::2] + dpad[0::2, 1::2] + dpad[1::2, 1::2]
        ms = mpad[0::2, 0::2] + mpad[1::2, 0::2] + mpad[0::2, 1::2] + mpad[1::2, 1::2]
        d = np.where(ms > 0, ds / np.maximum(ms, 1e-30), 0.0)
        m = (ms > 0).astype(np.float64)
        levels.append((d, m))
        if m.all():
            break
    # Coarse-to-fine: fill holes from the next-coarser level.
    d_coarse, m_coarse = levels[-1]
    if not m_coarse.all():
        fallback = d_coarse[m_coarse > 0].mean() if (m_coarse > 0).any() else 1.0
        d_coarse = np.where(m_coarse > 0, d_coarse, fallback)
    for d_fine, m_fine in reversed(levels[:-1]):
        up = np.repeat(np.repeat(d_coarse, 2, 0), 2, 1)[: d_fine.shape[0], : d_fine.shape[1]]
        d_coarse = np.where(m_fine > 0, d_fine, up)
    return d_coarse


def _feature_visibility(bundle, n_views: int, aabb_min, aabb_max):
    """(V, F) bool visibility of bundle features, AABB-filtered
    (dmrecon.cc analyzeFeatures)."""
    F = len(bundle.features)
    vis = np.zeros((n_views, F), bool)
    for fi, feat in enumerate(bundle.features):
        inside = np.all(feat.pos >= aabb_min) and np.all(feat.pos <= aabb_max)
        if not inside:
            continue
        for ref in feat.refs:
            if 0 <= ref.view_id < n_views:
                vis[ref.view_id, fi] = True
    return vis


def _scene_inputs(scene, s: Settings):
    """(views, feature positions, feature visibility, full image sizes):
    what every view's preparation reads from the scene."""
    with span("mvs.scene_inputs"):
        views = scene.get_views()
        bundle = scene.get_bundle()
        count("features", len(bundle.features))
        vis = _feature_visibility(bundle, len(views), s.aabb_min, s.aabb_max)
        full_sizes = [(0, 0) if v is None or not v.has_image(s.image_embedding)
                      else v.get_image_size(s.image_embedding) for v in views]
        return views, bundle.feature_positions(), vis, full_sizes


@span("mvs.prepare_view")
def _prepare_view(scene, s: Settings, views, positions, vis, full_sizes,
                  view_id: int, device="cpu") -> dict:
    """Host-side prep for one reference view: global view selection,
    level images, feature seeds, reprojection operators, ray geometry.
    device: the run's device, where level images that miss the cache are
    built (ImagePyramidCache.get_level); the result is the same. The
    images that miss are decoded together (ImagePyramidCache.prefetch),
    their levels built in turn."""
    from .sweep_solver import rectify_pair

    ref_view = views[view_id]
    if ref_view is None or not ref_view.camera.valid:
        raise ValueError(f"view {view_id} invalid")

    with span("mvs.view_selection"):
        count("vs_features", int(np.count_nonzero(vis[view_id])))
        cameras = [v.camera if v is not None else None for v in views]
        selected = global_view_selection(
            positions, vis, cameras, full_sizes, view_id,
            max_views=s.global_vs_max, min_parallax=s.min_parallax)
        selected = [v for v in selected
                    if views[v] is not None and views[v].has_image(s.image_embedding)]
    if len(selected) < s.nr_recon_neighbors:
        raise RuntimeError(
            f"view {view_id}: only {len(selected)} neighbors selected")

    ImagePyramidCache.prefetch(scene, [view_id] + selected, s.image_embedding, s.scale)
    ref_level = ImagePyramidCache.get_level(
        scene, view_id, s.image_embedding, s.scale, _to_gray, device=device)
    neigh_imgs = [ImagePyramidCache.get_level(scene, v, s.image_embedding,
                                              s.scale, _to_gray, device=device)
                  for v in selected]
    H, W = ref_level.shape
    ref_cam = ref_view.camera
    ref_wh = (W, H)

    # Feature seeds (dmrecon.cc processFeatures): project features, depth
    # = ray length.
    with span("mvs.seeds"):
        feat_ids = np.nonzero(vis[view_id])[0]
        seed_depth = np.zeros((H, W), np.float64)
        seed_mask = np.zeros((H, W), bool)
        if len(feat_ids):
            pts = positions[feat_ids]
            pc = (ref_cam.rot @ pts.T).T + ref_cam.trans
            K = ref_cam.calibration(W, H)
            proj = (K @ pc.T).T
            u = proj[:, 0] / proj[:, 2] - 0.5
            vpix = proj[:, 1] / proj[:, 2] - 0.5
            ray_len = np.linalg.norm(pc, axis=1)
            ok = (pc[:, 2] > 0) & (u >= 0) & (u < W) & (vpix >= 0) & (vpix < H)
            ui = np.round(u[ok]).astype(int)
            vi = np.round(vpix[ok]).astype(int)
            seed_depth[vi, ui] = ray_len[ok]
            seed_mask[vi, ui] = True
        if seed_mask.sum() < 3:
            raise RuntimeError(f"view {view_id}: too few feature seeds")

        dmin = float(seed_depth[seed_mask].min()) * 0.7
        dmax = float(seed_depth[seed_mask].max()) * 1.4
        init_depth = _fill_sparse(seed_depth, seed_mask).astype(np.float32)

    with span("mvs.rectify"):
        Ts, ts = [], []
        for v in selected:
            w2, h2 = _level_dims(*full_sizes[v], s.scale)
            T, tv = ref_cam.reprojection(views[v].camera, ref_wh, (w2, h2))
            Ts.append(T)
            ts.append(tv)

        # Ray geometry for the reference view.
        Ki = ref_cam.inverse_calibration(W, H)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        dirs = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1) @ Ki.T
        ray_norm = np.linalg.norm(dirs, axis=-1)
        ray_z = (dirs[..., 2] / ray_norm).astype(np.float32)
        ray_world = ((dirs / ray_norm[..., None]) @ ref_cam.rot).astype(np.float32)
        ref_pos = ref_cam.camera_pos()
        cam_rel = np.stack([views[v].camera.camera_pos() - ref_pos
                            for v in selected]).astype(np.float32)

        # Rectification data per pair (sweep_solver); None entries mean the
        # pair degenerates (baseline ~ viewing dir) -> warp-solver fallback.
        # Each pair's rect grid is FITTED to cover the whole mapped ref image
        # (rect_wh); _run_batch buckets the max over its batch into the grid
        # shape.
        K_ref = ref_cam.calibration(W, H)
        rect = []
        for v in selected:
            w2, h2 = _level_dims(*full_sizes[v], s.scale)
            cam_j = views[v].camera
            r = rectify_pair(K_ref, ref_cam.rot, ref_cam.trans,
                             cam_j.calibration(w2, h2), cam_j.rot, cam_j.trans,
                             image_wh=(W, H))
            if r is not None and max(r["rect_wh"]) > 4 * max(H, W):
                r = None  # extreme rectification: grid would explode
            if r is not None:
                # Inverse-rect-depth plane range covering [dmin, dmax] over
                # the whole ray fan: w' = 1/(L * c), c = e3 . ray_dir.
                c = ray_world @ r["e3"]
                cmin = float(np.clip(c.min(), 1e-3, None))
                cmax = float(np.clip(c.max(), cmin, None))
                w_lo = 1.0 / (dmax * cmax) * 0.95
                w_hi = 1.0 / (max(dmin, 1e-6) * cmin) * 1.05
                r["w0"] = w_lo
                r["dw"] = max(w_hi - w_lo, 1e-12)  # scaled by D-1 at pack
            rect.append(r)

    return dict(view_id=view_id, ref=ref_level.astype(np.float32),
                neigh=neigh_imgs, T=np.stack(Ts).astype(np.float32),
                tvec=np.stack(ts).astype(np.float32), ray_z=ray_z,
                init_depth=init_depth, dmin=dmin, dmax=dmax,
                ray_world=ray_world, cam_rel=cam_rel, rect=rect,
                n_selected=len(selected))


def _solver_params(s: Settings) -> dict:
    """Static solver configuration from Settings (solver.solve_batch)."""
    n_rel = max(s.num_sweep_planes // 2, 2)
    n_abs = max(s.num_sweep_planes - n_rel, 2)
    rel_factors = tuple(float(f) for f in np.geomspace(0.75, 1.3333, n_rel))
    n_plane_rounds = max(0, min((s.max_iterations + 4) // 5,
                                s.max_iterations - s.num_propagation_iters))
    return dict(fw=s.filter_width, k=s.nr_recon_neighbors,
                n_prop=s.num_propagation_iters, n_refine=s.num_refine_steps,
                n_plane_rounds=n_plane_rounds,
                use_local=bool(s.local_vs), exact=bool(s.exact_ncc),
                rel_factors=rel_factors), n_abs


def _sweep_capable(p, s: Settings) -> bool:
    """A view can use the sweep solver iff every neighbor rectifies."""
    return (s.use_sweep and not s.exact_ncc
            and all(r is not None for r in p["rect"]))


def _run_batch(prepared: list, s: Settings, device="cuda"):
    """Pad + stack prepared views, move them to the device once, run the
    solver and read the results back once (spans mvs.pack, mvs.upload, the
    solver's mvs.solve.<phase> or mvs.solve.warp_<phase>, mvs.readback).
    Counts the views by the solver they took (views_sweep, views_warp) in
    the enclosing span. Neighbors smaller than the padded neighbor tensor
    are bounded by their own size (the solver's neigh_hw).

    All views in `prepared` must agree on _sweep_capable. Returns
    (depth (B,H,W), conf, dz (B,H,W,2), n_accepted (B,)) numpy."""
    from .solver import solve_batch

    dev = resolve_device(device)
    params, n_abs = _solver_params(s)
    sweep = _sweep_capable(prepared[0], s)
    count("views_sweep" if sweep else "views_warp", len(prepared))
    host, neigh_hw, rect_hw = _pack(prepared, s, sweep, n_abs)
    with span("mvs.upload"):
        count("bytes_h2d", sum(a.nbytes for a in host))
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]
        if neigh_hw is not None:
            neigh_hw = torch.from_numpy(neigh_hw).to(dev)
    if sweep:
        from .sweep_solver import solve_batch_sweep

        out = solve_batch_sweep(
            *args, fw=params["fw"], k=params["k"], D=int(s.num_lookup_planes),
            n_prop=params["n_prop"], n_refine=params["n_refine"],
            n_plane_rounds=params["n_plane_rounds"], use_local=params["use_local"],
            rect_hw=rect_hw, neigh_hw=neigh_hw)
    else:
        out = solve_batch(*args, neigh_hw=neigh_hw, **params)
    with span("mvs.readback"):
        depth, conf, dz, n_acc = (t.cpu().numpy() for t in out)
        count("bytes_d2h", depth.nbytes + conf.nbytes + dz.nbytes + n_acc.nbytes)
    read_device_times()
    return depth, conf, dz, n_acc.astype(np.int32)


@span("mvs.pack")
def _pack(prepared: list, s: Settings, sweep: bool, n_abs: int):
    """The batch's host arrays, padded and stacked, in the order of the
    solver's arguments; the (B, Jmax, 2) float32 (height, width) of each
    neighbor image inside the padded (B, Jmax, Hn, Wn) neighbor tensor, or
    None where every one fills it; and the sweep solver's rect grid (None
    for the warp solver). Counts the pixels of the neighbor images
    (neigh_px) and of the padded tensor (neigh_px_padded)."""
    B = len(prepared)
    Jmax = max(p["T"].shape[0] for p in prepared)
    Hn = max(g.shape[0] for p in prepared for g in p["neigh"])
    Wn = max(g.shape[1] for p in prepared for g in p["neigh"])
    count("neigh_px", sum(g.size for p in prepared for g in p["neigh"]))
    count("neigh_px_padded", B * Jmax * Hn * Wn)

    ref = np.stack([p["ref"] for p in prepared])
    neigh = np.full((B, Jmax, Hn, Wn), -1e3, np.float32)
    neigh_hw = np.tile(np.float32([Hn, Wn]), (B, Jmax, 1))
    nvalid = np.zeros((B, Jmax), bool)
    T = np.tile(np.eye(3, dtype=np.float32), (B, Jmax, 1, 1))
    tvec = np.zeros((B, Jmax, 3), np.float32)
    cam_rel = np.zeros((B, Jmax, 3), np.float32)
    abs_planes = np.zeros((B, n_abs), np.float32)
    for b, p in enumerate(prepared):
        Jb = p["T"].shape[0]
        nvalid[b, :Jb] = True
        T[b, :Jb] = p["T"]
        tvec[b, :Jb] = p["tvec"]
        cam_rel[b, :Jb] = p["cam_rel"]
        for j, g in enumerate(p["neigh"]):
            neigh[b, j, : g.shape[0], : g.shape[1]] = g
            neigh_hw[b, j] = g.shape
        abs_planes[b] = np.geomspace(max(p["dmin"], 1e-4), p["dmax"], n_abs)
    ray_z = np.stack([p["ray_z"] for p in prepared])
    init_depth = np.stack([p["init_depth"] for p in prepared])
    dmin = np.asarray([p["dmin"] for p in prepared], np.float32)
    dmax = np.asarray([p["dmax"] for p in prepared], np.float32)
    ray_world = np.stack([p["ray_world"] for p in prepared])
    scalars = np.asarray([s.min_ncc, s.min_parallax, s.accept_ncc,
                          s.min_refine_diff], np.float32)

    if (neigh_hw == np.float32([Hn, Wn])).all():
        neigh_hw = None
    common = (ref, neigh, nvalid, T, tvec, ray_z)
    if not sweep:
        return (common + (init_depth, dmin, dmax, abs_planes, ray_world, cam_rel, scalars),
                neigh_hw, None)
    D = int(s.num_lookup_planes)
    M_ref = np.tile(np.eye(3, dtype=np.float32), (B, Jmax, 1, 1))
    M_nei = np.tile(np.eye(3, dtype=np.float32), (B, Jmax, 1, 1))
    H_fwd = np.tile(np.eye(3, dtype=np.float32), (B, Jmax, 1, 1))
    e3 = np.zeros((B, Jmax, 3), np.float32)
    e3[:, :, 2] = 1.0
    fB = np.ones((B, Jmax), np.float32)
    w0 = np.zeros((B, Jmax), np.float32)
    dw = np.ones((B, Jmax), np.float32)
    rect_w = rect_h = 1
    for b, p in enumerate(prepared):
        for j, r in enumerate(p["rect"]):
            M_ref[b, j] = r["M_ref"]
            M_nei[b, j] = r["M_nei"]
            H_fwd[b, j] = r["H_fwd"]
            e3[b, j] = r["e3"]
            fB[b, j] = r["fB"]
            w0[b, j] = r["w0"]
            dw[b, j] = r["dw"] / max(D - 1, 1)
            # tests/torch_legacy_grid.py (the tests' and chip_smoke.py's
            # legacy grid) sets rect_wh to (0, 0) for this packing.
            rect_w = max(rect_w, r["rect_wh"][0])
            rect_h = max(rect_h, r["rect_wh"][1])
    # Bucket the fitted grid to multiples of 32, as mve_tpu does (there
    # it bounds the number of compiled programs; the bucket also sets
    # the grid that the cube's clip bounds see, so it is kept).
    rect_hw = (-(-rect_h // 32) * 32, -(-rect_w // 32) * 32)
    return (common + (M_ref, M_nei, H_fwd, e3, fB, w0, dw, init_depth, dmin, dmax,
                      ray_world, cam_rel, scalars), neigh_hw, rect_hw)


def _batch_size_limit(H: int, W: int, J: int, s: Settings) -> int:
    """Views per solver dispatch, bounded so the biggest score tensors
    stay within a fixed memory budget (mve_tpu's, kept as it is: the
    center-plane acceptance and growing passes hold (J, K<=5, H, W) tap
    intermediates)."""
    per_view = max(J, 1) * 24 * H * W
    return max(1, int(1.0e8 // per_view))


def _write_outputs(view, s: Settings, depth, conf, dz, img_full=None):
    """Write depth/conf/dz/undist embeddings (dmrecon.cc:120-145)."""
    view.set_image(f"depth-L{s.scale}", depth[:, :, None])
    if s.keep_conf_map:
        view.set_image(f"conf-L{s.scale}", conf[:, :, None])
    if s.keep_dz_map:
        view.set_image(f"dz-L{s.scale}", dz)
    if s.scale != 0:
        if img_full is None:
            img_full = view.get_image(s.image_embedding)
        lvl_img = np.asarray(_image_at_level_color(img_full, s.scale))
        view.set_image(f"undist-L{s.scale}", lvl_img)


def _solve(chunk: list, s: Settings, dev, timings: dict):
    """_run_batch on one batch in an mvs.solve span, the device idle at its
    start; adds its wall time to timings["solve_ms"] and the batch to
    timings["batches"]."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with span("mvs.solve"):
        t1 = time.perf_counter()
        out = _run_batch(chunk, s, dev)
        timings["solve_ms"] += 1e3 * (time.perf_counter() - t1)
    H, W = chunk[0]["ref"].shape
    timings["batches"].append((len(chunk), "sweep" if _sweep_capable(chunk[0], s) else "warp",
                               H, W, max(p["T"].shape[0] for p in chunk)))
    return out


def _write(views, chunk: list, s: Settings, out, timings: dict, write_ply: bool) -> None:
    """Each view's maps of a solved batch, and its PLY with write_ply or
    s.write_ply_file, in an mvs.write span a view; adds their wall time to
    timings["write_ms"]."""
    depth, conf, dz, _ = out
    for b, p in enumerate(chunk):
        vid = p["view_id"]
        sv = dataclasses.replace(s, ref_view_nr=vid)
        with span("mvs.write"):
            t2 = time.perf_counter()
            _write_outputs(views[vid], sv, depth[b], conf[b], dz[b])
            if write_ply or s.write_ply_file:
                _write_ply_for(views[vid], sv, depth[b])
            timings["write_ms"] += 1e3 * (time.perf_counter() - t2)


def reconstruct_batch(scene: Scene, base: Settings, view_ids,
                      verbose: bool = True, write_ply: bool = False,
                      device="cuda"):
    """Reconstruct many views of one scene in batched solver calls.

    view_ids: iterable of (view_id, scale) pairs. Returns
    {view_id: filled_ratio}; failed views are reported and skipped."""
    dev = resolve_device(device)
    with span("mvs.prepare"):
        t0 = time.perf_counter()
        views, positions, vis, full_sizes = _scene_inputs(scene, base)

        # Prepare all views on host, grouped by (scale, H, W).
        groups: dict = {}
        results: dict = {}
        for view_id, scale in view_ids:
            s = dataclasses.replace(base, ref_view_nr=view_id, scale=scale)
            try:
                prep = _prepare_view(scene, s, views, positions, vis,
                                     full_sizes, view_id, dev)
            except (RuntimeError, ValueError) as exc:
                if verbose:
                    print(f"View {view_id}: {exc}")
                continue
            key = (scale, prep["ref"].shape, _sweep_capable(prep, s))
            groups.setdefault(key, []).append(prep)
        count("solver_groups", len(groups))
        timings = dict(prepare_ms=1e3 * (time.perf_counter() - t0), solve_ms=0.0,
                       write_ms=0.0, batches=[])

    for (scale, (H, W), _), prepared in groups.items():
        s = dataclasses.replace(base, scale=scale)
        bsz = _batch_size_limit(H, W, max(p["T"].shape[0] for p in prepared), s)
        for i in range(0, len(prepared), bsz):
            chunk = prepared[i : i + bsz]
            out = _solve(chunk, s, dev, timings)
            _write(views, chunk, s, out, timings, write_ply)
            for b, p in enumerate(chunk):
                filled = float(out[3][b]) / (H * W)
                results[p["view_id"]] = filled
                if verbose and not s.quiet:
                    print(f"View {p['view_id']}: filled {100.0 * filled:.1f}% "
                          f"({p['n_selected']} neighbors)")
    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(timings)
    return results


def _write_ply_for(ref_view, s: Settings, depth) -> None:
    """saveReconAsPly (dmrecon.cc:109-116, single_view.cc): triangulate
    the accepted depth map and write it to <ply_path>/."""
    from ..core import depthmap as dmod
    from ..core import mesh_io
    from ..core.mesh_tools import mesh_transform

    H, W = depth.shape
    ref_cam = ref_view.camera
    invproj = ref_cam.inverse_calibration(W, H)
    mesh, _ = dmod.depthmap_triangulate(depth, invproj, dd_factor=5.0)
    mesh_transform(mesh, ref_cam.cam_to_world())
    os.makedirs(s.ply_path or ".", exist_ok=True)
    out = os.path.join(s.ply_path or ".",
                       f"view_{s.ref_view_nr:04d}-L{s.scale}.ply")
    mesh_io.save_mesh(mesh, out)


class DMRecon:
    """Mirrors mvs::DMRecon (dmrecon.h:40-68): one view's reconstruction.

    device: where the solver runs ("cuda" by default; "cpu" on request)."""

    def __init__(self, scene: Scene, settings: Settings, device="cuda"):
        from .progress import Progress

        self.scene = scene
        self.settings = settings
        self.device = resolve_device(device)
        self.filled_ratio = 0.0
        self.progress = Progress()

    def start(self) -> None:
        """Reconstruct settings.ref_view_nr through reconstruct_batch's
        steps and spans (LAST_TIMINGS too); raises where that reports and
        skips a view."""
        from .progress import ReconStatus

        self.progress.begin()
        s = self.settings
        with span("mvs.prepare"):
            t0 = time.perf_counter()
            self.progress.status = ReconStatus.GLOBALVS
            self.progress.check_cancelled()
            views, positions, vis, full_sizes = _scene_inputs(self.scene, s)

            self.progress.status = ReconStatus.FEATURES
            self.progress.check_cancelled()
            prep = _prepare_view(self.scene, s, views, positions, vis, full_sizes,
                                 s.ref_view_nr, self.device)
            timings = dict(prepare_ms=1e3 * (time.perf_counter() - t0), solve_ms=0.0,
                           write_ms=0.0, batches=[])

        self.progress.status = ReconStatus.QUEUE
        self.progress.check_cancelled()
        out = _solve([prep], s, self.device, timings)
        H, W = prep["ref"].shape
        self.filled_ratio = float(out[3][0]) / (H * W)
        self.progress.filled = int(out[3][0])
        self.progress.status = ReconStatus.SAVING
        _write(views, [prep], s, out, timings, write_ply=False)
        LAST_TIMINGS.clear()
        LAST_TIMINGS.update(timings)
        self.progress.status = ReconStatus.IDLE
        self.progress.queue_size = 0
        if not s.quiet:
            print(f"View {s.ref_view_nr}: filled "
                  f"{100.0 * self.filled_ratio:.1f}% "
                  f"({prep['n_selected']} neighbors)")


def _image_at_level_color(img: np.ndarray, level: int) -> np.ndarray:
    out = image_tools.to_float(img)
    for _ in range(level):
        out = half_size_gaussian_np(out)
    return image_tools.to_byte(out)
