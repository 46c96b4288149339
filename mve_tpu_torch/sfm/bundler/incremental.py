"""Incremental SfM state machine (reference: libs/sfm/bundler_incremental.cc;
port of mve_tpu/sfm/bundler/incremental.py).

Host orchestration (numpy) around two device paths: P3P RANSAC
resectioning (ransac.ransac_pose_p3p) and LM bundle adjustment (ba/).
Pair-exhaustive track triangulation, median track-error pruning, survey
registration and scene normalisation are host numpy, as in mve_tpu. The
control flow (find_next_views ranking, 33% inlier threshold, track
backup/restore, BA cadence) replicates the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ... import resolve_device
from ...core.bundle import Bundle, Feature2D, Feature3D
from ...core.camera import CameraInfo
from ..ba import BAOptions, BundleMode
from ..ba.lm import _bucket, optimize_arrays
from ..pose import CameraPose
from ..ransac import RansacOptions, ransac_pose_p3p
from .common import (FeatureReference, SurveyPoint, Track, Viewport,
                     undistort_features)


@dataclasses.dataclass
class IncrementalOptions:
    """bundler_incremental.h:110-119 defaults."""

    pose_p3p_opts: RansacOptions = dataclasses.field(
        default_factory=lambda: RansacOptions(max_iterations=1000, threshold=0.005))
    track_error_threshold_factor: float = 10.0
    new_track_error_threshold: float = 0.01
    min_triangulation_angle: float = np.deg2rad(1.0)
    ba_fixed_intrinsics: bool = False
    verbose_output: bool = False
    verbose_ba: bool = False


class Incremental:
    def __init__(self, options: Optional[IncrementalOptions] = None, device="cuda"):
        self.opts = options or IncrementalOptions()
        self.device = resolve_device(device)
        self.viewports: List[Viewport] = []
        self.tracks: List[Track] = []
        self.survey_points: Optional[List[SurveyPoint]] = None
        self.registered = False
        self.last_ba_status = None  # BAStatus of the most recent BA
        # Totals over every BA of the run: BAs, LM steps, CG iterations
        # and milliseconds.
        self.ba_totals = {"n_ba": 0, "lm_iters": 0, "cg_iters": 0, "ms": 0}

    def initialize(self, viewports: List[Viewport], tracks: List[Track],
                   survey_points: Optional[List[SurveyPoint]] = None) -> None:
        self.viewports = viewports
        self.tracks = tracks
        self.survey_points = survey_points or None
        self._compute_fixed_shapes()

    def is_initialized(self) -> bool:
        return bool(self.viewports)

    # ------------------------------------------------------------------
    def _compute_fixed_shapes(self) -> None:
        """Pre-size padded problem shapes for the whole run, as mve_tpu
        does (there, each padded shape is a compile). The pads decide
        PCG's iteration cap (9 x padded cameras), so the port keeps them.
        Bounds known up front: total feature references never grow
        (resection outliers are backed up and restored, splits just move
        refs), so (cams, points, obs) for any full BA are bounded by
        (#views, #tracks, #refs); single-cam BA by the max per-view
        feature count."""
        V = max(len(self.viewports), 1)
        total_refs = sum(len(t.features) for t in self.tracks)
        max_feats = max((len(vp.positions) for vp in self.viewports),
                        default=1)
        self._pad_full = (_bucket(V, 16),
                          _bucket(max(len(self.tracks), 1), 256),
                          _bucket(max(total_refs, 1), 512))
        self._pad_single = (16, _bucket(max_feats, 256),
                            _bucket(max_feats, 512))
        self.opts.pose_p3p_opts.min_pad = _bucket(max_feats, 64)
        # Flat position table for O(1) vectorized observation gathers.
        offs = np.zeros(len(self.viewports) + 1, np.int64)
        for i, vp in enumerate(self.viewports):
            offs[i + 1] = offs[i] + len(vp.positions)
        self._pos_off = offs
        if offs[-1]:
            self._pos_all = np.concatenate(
                [np.asarray(vp.positions, np.float64)
                 if len(vp.positions) else np.zeros((0, 2))
                 for vp in self.viewports])
        else:
            self._pos_all = np.zeros((0, 2))

    def _tier_pads(self, C: int, P: int, O: int) -> tuple:
        """Shrink the final-run pads by a power-of-4 factor while the
        current problem still fits: early (small) BAs don't pay the
        final problem's cost, yet the whole run uses only O(log4) shapes."""
        Cf, Pf, Of = getattr(self, "_pad_full", (16, 256, 512))
        pads = (Cf, Pf, Of)
        s = 4
        while True:
            cand = (max(16, Cf // s), max(256, Pf // s), max(512, Of // s))
            if C <= cand[0] and P <= cand[1] and O <= cand[2]:
                pads = cand
                s *= 4
                if cand == (16, 256, 512):
                    break
            else:
                break
        return pads

    def _track_valid_array(self) -> np.ndarray:
        if not self.tracks:
            return np.zeros(0, bool)
        pos0 = np.array([t.pos[0] for t in self.tracks])
        return ~np.isnan(pos0)

    # ------------------------------------------------------------------
    def find_next_views(self) -> List[int]:
        """Rank unreconstructed views by number of valid observed tracks;
        keep those with > 6 (bundler_incremental.cc:55-87)."""
        track_valid = self._track_valid_array()
        counts = np.zeros(len(self.viewports), np.int64)
        for i, vp in enumerate(self.viewports):
            if vp.pose.is_valid():
                continue
            tids = np.asarray(vp.track_ids)
            m = tids >= 0
            if m.any():
                counts[i] = np.count_nonzero(track_valid[tids[m]])
        order = np.argsort(-counts, kind="stable")
        return [int(v) for v in order if counts[v] > 6]

    # ------------------------------------------------------------------
    def reconstruct_next_view(self, view_id: int) -> bool:
        """P3P-RANSAC resectioning with track backup of outliers
        (bundler_incremental.cc:92-190)."""
        vp = self.viewports[view_id]
        track_valid = self._track_valid_array()
        tids_all = np.asarray(vp.track_ids)
        sel = np.nonzero((tids_all >= 0)
                         & track_valid[np.clip(tids_all, 0, None)])[0]
        if sel.size < 3:
            return False
        track_ids = tids_all[sel]
        feature_ids = sel
        corr_3d = np.stack([self.tracks[int(t)].pos for t in track_ids])
        corr_2d = np.asarray(vp.positions[sel], np.float64)

        K = np.array([[vp.focal_length, 0, 0], [0, vp.focal_length, 0], [0, 0, 1.0]])
        try:
            result = ransac_pose_p3p(
                corr_3d, corr_2d, K, self.opts.pose_p3p_opts, device=self.device)
        except ValueError:
            return False

        if 3 * len(result.inliers) < len(corr_3d):
            if self.opts.verbose_output:
                print(f"Only {len(result.inliers)} 2D-3D inliers "
                      f"({100 * len(result.inliers) // len(corr_3d)}%). Skipping view.")
            return False

        # Back up outlier tracks for later restore.
        outlier_mask = np.ones(len(sel), bool)
        outlier_mask[result.inliers] = False
        for i in np.nonzero(outlier_mask)[0]:
            tid, fid = int(track_ids[i]), int(feature_ids[i])
            self.tracks[tid].remove_view(view_id)
            vp.track_ids[fid] = -1
            vp.backup_tracks[fid] = tid

        pose = CameraPose()
        pose.set_k_matrix(vp.focal_length, 0.0, 0.0)
        pose.R = result.R
        pose.t = result.t
        vp.pose = pose
        if self.opts.verbose_output:
            print(f"Reconstructed camera {view_id} with focal length "
                  f"{pose.get_focal_length():.5f}")

        if self.survey_points is not None and not self.registered:
            self.try_registration()
        return True

    # ------------------------------------------------------------------
    def try_restore_tracks_for_views(self) -> None:
        """Re-attach backed-up tracks whose reprojection now fits
        (bundler_incremental.cc:194-229). Vectorized per view: all
        backed-up candidates of a view project in one batch."""
        track_valid = self._track_valid_array()
        for view_id, vp in enumerate(self.viewports):
            if not vp.pose.is_valid() or not vp.backup_tracks:
                continue
            items = np.array([(fid, tid) for fid, tid in vp.backup_tracks.items()],
                             np.int64).reshape(-1, 2)
            fids, tids = items[:, 0], items[:, 1]
            m = (tids >= 0) & track_valid[np.clip(tids, 0, None)] \
                & (np.asarray(vp.track_ids)[fids] < 0)
            if not m.any():
                continue
            fids, tids = fids[m], tids[m]
            P = vp.pose.fill_p_matrix()
            pos3d = np.stack([self.tracks[int(t)].pos for t in tids])
            pos2d = undistort_features(
                np.asarray(vp.positions[fids], np.float64),
                float(vp.radial_distortion[0]),
                float(vp.radial_distortion[1]), vp.focal_length)
            proj = pos3d @ P[:, :3].T + P[:, 3]
            z = np.where(np.abs(proj[:, 2:]) < 1e-30, 1e-30, proj[:, 2:])
            err = np.linalg.norm(proj[:, :2] / z - pos2d, axis=1)
            for fid, tid in zip(fids[err < self.opts.new_track_error_threshold],
                                tids[err < self.opts.new_track_error_threshold]):
                vp.track_ids[int(fid)] = int(tid)
                self.tracks[int(tid)].features.append(
                    FeatureReference(view_id, int(fid)))

    # ------------------------------------------------------------------
    def triangulate_new_tracks(self, min_num_views: int = 2) -> None:
        """Pair-exhaustive triangulation with outlier splitting
        (bundler_incremental.cc:300-380, triangulate.cc Triangulate).

        Vectorized: all candidate tracks' pose pairs triangulate in one
        batched DLT; per-pair outlier evaluation over padded view lists;
        best pair per track selected by fewest outliers.
        """
        error_thr = self.opts.new_track_error_threshold
        cos_angle_thr = np.cos(self.opts.min_triangulation_angle)
        n_tracks_before = len(self.tracks)

        # ---- collect candidate tracks and their valid observations.
        cand_tracks = []   # track index
        obs_views = []     # list of arrays of view ids
        obs_feats = []
        obs_pos = []       # list of (V_i, 2) undistorted positions
        valid_pose = np.array([vp.pose.is_valid() for vp in self.viewports])
        und_cache = {}
        for ti in range(n_tracks_before):
            track = self.tracks[ti]
            if track.is_valid() or not track.features:
                continue
            vids = np.array([r.view_id for r in track.features], np.int64)
            fids = np.array([r.feature_id for r in track.features], np.int64)
            ok = valid_pose[vids]
            if int(ok.sum()) < min_num_views:
                continue
            vids, fids = vids[ok], fids[ok]
            ps = []
            for vid, fid in zip(vids, fids):
                vp = self.viewports[vid]
                key = vid
                if key not in und_cache:
                    und_cache[key] = undistort_features(
                        vp.positions, float(vp.radial_distortion[0]),
                        float(vp.radial_distortion[1]), vp.focal_length)
                ps.append(und_cache[key][fid])
            cand_tracks.append(ti)
            obs_views.append(vids)
            obs_feats.append(fids)
            obs_pos.append(np.asarray(ps, np.float64))
        if not cand_tracks:
            if self.opts.verbose_output:
                print("Triangulated 0 new tracks.")
            return

        n_valid_views = len(self.viewports)
        pm_all = np.zeros((n_valid_views, 3, 4))
        ctr_all = np.zeros((n_valid_views, 3))
        for i, vp in enumerate(self.viewports):
            if valid_pose[i]:
                pm_all[i] = vp.pose.fill_p_matrix()
                ctr_all[i] = vp.pose.fill_camera_pos()

        # ---- per-candidate padded view tables (built once, reused by
        # the pair expansion AND the outlier projection).
        C_n = len(cand_tracks)
        nviews = np.array([len(v) for v in obs_views], np.int64)
        Vmax = int(nviews.max())
        pad_vid = np.zeros((C_n, Vmax), np.int64)
        pad_obs = np.zeros((C_n, Vmax, 2))
        pad_valid = np.zeros((C_n, Vmax), bool)
        for ci, (vids, ps) in enumerate(zip(obs_views, obs_pos)):
            pad_vid[ci, :len(vids)] = vids
            pad_obs[ci, :len(vids)] = ps
            pad_valid[ci, :len(vids)] = True
        pad_P = pm_all[pad_vid] * pad_valid[:, :, None, None]

        # ---- pose pairs, vectorized by view-count group (the per-pair
        # Python loop dominated 100-view incremental wall-clock: late
        # full-BA rounds see tracks with dozens of valid views, i.e.
        # V(V-1)/2 pairs each).
        rows_t_l, pa_l, pb_l, ia_l, ib_l = [], [], [], [], []
        cand_idx = np.arange(C_n)
        for V in np.unique(nviews):
            sel = cand_idx[nviews == V]
            ai, bi = np.triu_indices(int(V), k=1)
            P2 = len(ai)
            if P2 == 0:
                continue
            rows_t_l.append(np.repeat(sel, P2))
            pa_l.append(pad_obs[sel][:, ai].reshape(-1, 2))
            pb_l.append(pad_obs[sel][:, bi].reshape(-1, 2))
            ia_l.append(np.tile(ai, len(sel)))
            ib_l.append(np.tile(bi, len(sel)))
        rows_t = np.concatenate(rows_t_l)
        pa = np.concatenate(pa_l)
        pb = np.concatenate(pb_l)
        ia = np.concatenate(ia_l)
        ib = np.concatenate(ib_l)
        Pa = pad_P[rows_t, ia]
        Pb = pad_P[rows_t, ib]
        Ca = ctr_all[pad_vid[rows_t, ia]]
        Cb = ctr_all[pad_vid[rows_t, ib]]
        R = len(rows_t)

        # ---- batched two-view DLT + angle check + padded outlier
        # counts, CHUNKED over pair rows: R x Vmax projection tensors at
        # 100-view scale otherwise peak at many GB of RSS.
        X = np.zeros((R, 3))
        n_out = np.zeros(R, np.int64)
        usable = np.zeros(R, bool)
        outlier_rows = np.zeros((R, Vmax), bool)
        CH = 200_000
        for c0 in range(0, R, CH):
            sl = slice(c0, min(c0 + CH, R))
            A = np.stack([
                pa[sl, 0, None] * Pa[sl, 2] - Pa[sl, 0],
                pa[sl, 1, None] * Pa[sl, 2] - Pa[sl, 1],
                pb[sl, 0, None] * Pb[sl, 2] - Pb[sl, 0],
                pb[sl, 1, None] * Pb[sl, 2] - Pb[sl, 1],
            ], axis=1)  # (r, 4, 4)
            _, _, vt = np.linalg.svd(A)
            Xh = vt[:, -1, :]
            w = Xh[:, 3]
            Xc = Xh[:, :3] / np.where(np.abs(w[:, None]) < 1e-30, 1e-30,
                                      w[:, None])
            finite = np.isfinite(Xc).all(axis=1)
            r0 = Xc - Ca[sl]
            r1 = Xc - Cb[sl]
            n0 = np.linalg.norm(r0, axis=1)
            n1 = np.linalg.norm(r1, axis=1)
            cosang = np.sum(r0 * r1, axis=1) / np.maximum(n0 * n1, 1e-30)
            angle_ok = cosang <= cos_angle_thr

            rt = rows_t[sl]
            rp = pad_P[rt]
            robs = pad_obs[rt]
            rvalid = pad_valid[rt]
            Xh1 = np.concatenate([Xc, np.ones((len(Xc), 1))], axis=1)
            proj = np.einsum("rvij,rj->rvi", rp, Xh1)
            behind = proj[..., 2] <= 0.0
            uv = proj[..., :2] / np.where(
                np.abs(proj[..., 2:]) < 1e-30, 1e-30, proj[..., 2:])
            err = np.linalg.norm(uv - robs, axis=-1)
            out = (behind | (err > error_thr)) & rvalid
            X[sl] = Xc
            outlier_rows[sl] = out
            n_out[sl] = out.sum(axis=1)
            usable[sl] = finite & angle_ok
        outlier = outlier_rows
        n_out_eff = np.where(usable, n_out, Vmax + 1)

        # ---- best pair per track.
        order = np.lexsort((n_out_eff, rows_t))
        first = np.ones(len(order), bool)
        first[1:] = rows_t[order][1:] != rows_t[order][:-1]
        best_rows = order[first]

        n_new = 0
        for row in best_rows:
            ci = int(rows_t[row])
            if not usable[row]:
                continue
            vids = obs_views[ci]
            fids = obs_feats[ci]
            V = len(vids)
            outs = np.nonzero(outlier[row][:V])[0]
            if V < len(outs) + min_num_views:
                continue
            ti = cand_tracks[ci]
            track = self.tracks[ti]
            track.pos = X[row].copy()
            n_new += 1
            if len(outs):
                new_track = Track()
                new_track.invalidate()
                new_track.color = track.color.copy()
                for oi in outs:
                    vid, fid = int(vids[oi]), int(fids[oi])
                    track.remove_view(vid)
                    new_track.features.append(FeatureReference(vid, fid))
                    self.viewports[vid].track_ids[fid] = len(self.tracks)
                self.tracks.append(new_track)
        if self.opts.verbose_output:
            print(f"Triangulated {n_new} new tracks, split "
                  f"{len(self.tracks) - n_tracks_before}.")

    # ------------------------------------------------------------------
    def bundle_adjustment_full(self) -> None:
        self._bundle_adjustment_intern(-1)

    def bundle_adjustment_single_cam(self, view_id: int) -> None:
        if (view_id < 0 or view_id >= len(self.viewports)
                or not self.viewports[view_id].pose.is_valid()):
            raise ValueError("Invalid view ID")
        self._bundle_adjustment_intern(view_id)

    def bundle_adjustment_points_only(self) -> None:
        self._bundle_adjustment_intern(-2)

    def _bundle_adjustment_intern(self, single_camera_ba: int) -> None:
        """Map viewports/tracks to dense BA arrays and back
        (bundler_incremental.cc:416-575).

        Builds numpy struct-of-arrays directly (no per-observation
        objects) and calls ba.lm.optimize_arrays with run-wide fixed
        pads. Single-camera BA includes only the points the camera
        observes: points are constants in CAMERAS mode, so unobserved
        points contribute nothing."""
        opts = BAOptions(
            fixed_intrinsics=self.opts.ba_fixed_intrinsics,
            verbose_output=False)
        if single_camera_ba >= 0:
            opts.bundle_mode = BundleMode.CAMERAS
        elif single_camera_ba == -2:
            opts.bundle_mode = BundleMode.POINTS
        else:
            opts.bundle_mode = BundleMode.CAMERAS_AND_POINTS

        valid_pose = np.array([vp.pose.is_valid() for vp in self.viewports])
        track_valid = self._track_valid_array()
        if single_camera_ba >= 0:
            cam_ids = [single_camera_ba] if valid_pose[single_camera_ba] else []
        else:
            cam_ids = [i for i in range(len(self.viewports)) if valid_pose[i]]
        if not cam_ids:
            return
        cam_mapping = np.full(len(self.viewports), -1, np.int64)
        cam_mapping[cam_ids] = np.arange(len(cam_ids))
        intr = np.array([[self.viewports[i].pose.get_focal_length(),
                          self.viewports[i].radial_distortion[0],
                          self.viewports[i].radial_distortion[1]]
                         for i in cam_ids], np.float64)
        trans = np.array([self.viewports[i].pose.t for i in cam_ids], np.float64)
        rot = np.array([self.viewports[i].pose.R for i in cam_ids], np.float64)

        if single_camera_ba >= 0:
            # Observed valid tracks only; fixed per-run problem shape.
            vp = self.viewports[single_camera_ba]
            tids_all = np.asarray(vp.track_ids)
            sel = np.nonzero((tids_all >= 0)
                             & track_valid[np.clip(tids_all, 0, None)])[0]
            if sel.size == 0:
                return
            sel_tids = tids_all[sel]
            points = np.stack([self.tracks[int(t)].pos for t in sel_tids])
            obs = np.asarray(vp.positions[sel], np.float64)
            cam_idx = np.zeros(sel.size, np.int32)
            pt_idx = np.arange(sel.size, dtype=np.int32)
            valid_track_idx = sel_tids  # unused for write-back (CAMERAS)
            opts.pad_cameras, opts.pad_points, opts.pad_observations = \
                getattr(self, "_pad_single", (0, 0, 0))
        else:
            valid_track_idx = np.nonzero(track_valid)[0]
            if valid_track_idx.size == 0:
                return
            track_mapping = np.full(len(self.tracks), -1, np.int64)
            track_mapping[valid_track_idx] = np.arange(valid_track_idx.size)
            points = np.stack([self.tracks[int(i)].pos for i in valid_track_idx])
            ov, of_, ot = [], [], []
            for k, ti in enumerate(valid_track_idx):
                for ref in self.tracks[int(ti)].features:
                    if valid_pose[ref.view_id]:
                        ov.append(ref.view_id)
                        of_.append(ref.feature_id)
                        ot.append(k)
            if not ov:
                return
            ov = np.asarray(ov, np.int64)
            of_ = np.asarray(of_, np.int64)
            cam_idx = cam_mapping[ov].astype(np.int32)
            pt_idx = np.asarray(ot, np.int32)
            obs = self._pos_all[self._pos_off[ov] + of_]
            opts.pad_cameras, opts.pad_points, opts.pad_observations = \
                self._tier_pads(len(cam_ids), points.shape[0], obs.shape[0])

        if self.survey_points is not None and self.registered:
            extra_pts, extra_obs, extra_ci, extra_pi = [], [], [], []
            base = points.shape[0]
            for sp in self.survey_points:
                extra_pts.append(np.asarray(sp.pos, np.float64))
                for sobs in sp.observations:
                    if not valid_pose[sobs.view_id]:
                        continue
                    if single_camera_ba >= 0 and sobs.view_id != single_camera_ba:
                        continue
                    extra_obs.append(np.asarray(sobs.pos, np.float64))
                    extra_ci.append(int(cam_mapping[sobs.view_id]))
                    extra_pi.append(base + len(extra_pts) - 1)
            if extra_obs:
                points = np.concatenate([points, np.stack(extra_pts)])
                obs = np.concatenate([obs, np.stack(extra_obs)])
                cam_idx = np.concatenate(
                    [cam_idx, np.asarray(extra_ci, np.int32)])
                pt_idx = np.concatenate(
                    [pt_idx, np.asarray(extra_pi, np.int32)])

        new_intr, new_trans, new_rot, new_points, status = optimize_arrays(
            intr, trans, rot, points, obs, cam_idx, pt_idx, opts, self.device)
        self.last_ba_status = status
        for key, val in (("n_ba", 1), ("lm_iters", status.num_lm_iterations),
                         ("cg_iters", status.num_cg_iterations), ("ms", status.runtime_ms)):
            self.ba_totals[key] += val
        if self.opts.verbose_ba:
            print(f"BA: MSE {status.initial_mse:.6e} -> {status.final_mse:.6e}, "
                  f"{status.num_lm_iterations} LM iters, "
                  f"{status.num_cg_iterations} CG iters, {status.runtime_ms} ms")

        # Transfer cameras back.
        for k, i in enumerate(cam_ids):
            vp = self.viewports[i]
            vp.pose.t = new_trans[k].copy()
            vp.pose.R = new_rot[k].copy()
            vp.radial_distortion[:] = new_intr[k, 1:3]
            vp.pose.set_k_matrix(float(new_intr[k, 0]), 0.0, 0.0)

        if single_camera_ba >= 0:
            return
        # Transfer tracks back.
        for k, ti in enumerate(valid_track_idx):
            self.tracks[int(ti)].pos = new_points[k].copy()

    # ------------------------------------------------------------------
    def invalidate_large_error_tracks(self) -> None:
        """Drop tracks whose mean squared reprojection error exceeds
        factor x median error (bundler_incremental.cc:578-655)."""
        # Flatten all (track, observation) pairs and evaluate vectorized.
        valid_pose = np.array([vp.pose.is_valid() for vp in self.viewports])
        obs_t, obs_v, obs_f = [], [], []
        track_ids = []
        for i, track in enumerate(self.tracks):
            if not track.is_valid():
                continue
            track_ids.append(i)
            for ref in track.features:
                if valid_pose[ref.view_id]:
                    obs_t.append(len(track_ids) - 1)
                    obs_v.append(ref.view_id)
                    obs_f.append(ref.feature_id)
        if len(track_ids) < 2 or not obs_t:
            return
        obs_t = np.array(obs_t)
        obs_v = np.array(obs_v)
        obs_f = np.array(obs_f)
        T = len(track_ids)
        pos3d = np.array([self.tracks[i].pos for i in track_ids])
        Rm = np.array([self.viewports[v].pose.R for v in obs_v])
        tv = np.array([self.viewports[v].pose.t for v in obs_v])
        flen = np.array([self.viewports[v].pose.get_focal_length() for v in obs_v])
        k0 = np.array([self.viewports[v].radial_distortion[0] for v in obs_v])
        k1 = np.array([self.viewports[v].radial_distortion[1] for v in obs_v])
        p2d = np.array([self.viewports[v].positions[f] for v, f in zip(obs_v, obs_f)],
                       np.float64)
        x = np.einsum("oij,oj->oi", Rm, pos3d[obs_t]) + tv
        x2d = x[:, :2] / np.where(np.abs(x[:, 2:]) < 1e-30, 1e-30, x[:, 2:])
        r2 = np.sum(x2d * x2d, axis=1)
        factor = (1.0 + r2 * (k0 + k1 * r2)) * flen
        d = p2d - x2d * factor[:, None]
        sq = np.sum(d * d, axis=1)
        total = np.zeros(T)
        count = np.zeros(T)
        np.add.at(total, obs_t, sq)
        np.add.at(count, obs_t, 1)
        ok = count > 0
        errs = total[ok] / count[ok]
        all_errors = list(zip(errs, np.array(track_ids)[ok]))
        nth = len(errs) // 2
        median = np.partition(errs, nth)[nth]
        threshold = median * self.opts.track_error_threshold_factor
        n_deleted = 0
        for err, ti in all_errors:
            if err > threshold:
                self.tracks[ti].invalidate()
                n_deleted += 1
        if self.opts.verbose_output:
            print(f"Deleted {n_deleted} of {len(all_errors)} tracks above "
                  f"threshold {np.sqrt(threshold):.6f}.")

    # ------------------------------------------------------------------
    def try_registration(self) -> None:
        """Similarity-align to survey points (bundler_incremental.cc:234-297)."""
        p0, p1 = [], []
        for sp in self.survey_points or []:
            pos, poses = [], []
            for obs in sp.observations:
                if not self.viewports[obs.view_id].pose.is_valid():
                    continue
                pos.append(obs.pos)
                poses.append(self.viewports[obs.view_id].pose)
            if len(pos) < 2:
                continue
            X = _triangulate_nview(poses, pos)
            p0.append(X)
            p1.append(sp.pos)
        if len(p0) < 3:
            return
        transform = _determine_similarity(np.asarray(p0), np.asarray(p1))
        if transform is None:
            return
        R, s, t = transform
        for vp in self.viewports:
            if not vp.pose.is_valid():
                continue
            vp.pose.t = -vp.pose.R @ R.T @ t + vp.pose.t * s
            vp.pose.R = vp.pose.R @ R.T
        for track in self.tracks:
            if track.is_valid():
                track.pos = R @ (s * track.pos) + t
        self.registered = True

    # ------------------------------------------------------------------
    def normalize_scene(self) -> None:
        """Center camera mean, scale AABB of camera centers to 10
        (bundler_incremental.cc:657-717)."""
        self.registered = False
        centers = []
        for vp in self.viewports:
            if vp.pose.is_valid():
                centers.append(vp.pose.fill_camera_pos())
        if not centers:
            return
        centers = np.asarray(centers)
        aabb_min = centers.min(axis=0)
        aabb_max = centers.max(axis=0)
        scale = 10.0 / max((aabb_max - aabb_min).max(), 1e-30)
        trans = -centers.mean(axis=0)
        for track in self.tracks:
            if track.is_valid():
                track.pos = (track.pos + trans) * scale
        for vp in self.viewports:
            if vp.pose.is_valid():
                vp.pose.t = vp.pose.t * scale - vp.pose.R @ trans * scale

    # ------------------------------------------------------------------
    def create_bundle(self) -> Bundle:
        """Export to an mve Bundle (bundler_incremental.cc:752-828)."""
        bundle = Bundle()
        for vp in self.viewports:
            cam = CameraInfo()
            if vp.pose.is_valid():
                cam.flen = float(vp.pose.get_focal_length())
                cam.ppoint = np.array([vp.pose.K[0, 2] + 0.5, vp.pose.K[1, 2] + 0.5], np.float32)
                cam.rot = vp.pose.R.astype(np.float32)
                cam.trans = vp.pose.t.astype(np.float32)
                cam.dist = vp.radial_distortion.astype(np.float32)
            bundle.cameras.append(cam)
        for track in self.tracks:
            if not track.is_valid():
                continue
            refs = []
            for ref in track.features:
                pos2d = self.viewports[ref.view_id].positions[ref.feature_id]
                refs.append(Feature2D(ref.view_id, ref.feature_id,
                                      np.asarray(pos2d, np.float32).copy()))
            bundle.features.append(Feature3D(
                track.pos.astype(np.float32),
                track.color.astype(np.float32) / 255.0,
                refs))
        return bundle


# ---------------------------------------------------------------------------
# triangulation helpers
# ---------------------------------------------------------------------------

def _triangulate_nview(poses: List[CameraPose], positions) -> np.ndarray:
    """Plain N-view DLT (triangulate.cc triangulate_track)."""
    rows = []
    for pose, p in zip(poses, positions):
        P = pose.fill_p_matrix()
        rows.append(p[0] * P[2] - P[0])
        rows.append(p[1] * P[2] - P[1])
    A = np.asarray(rows)
    _, _, vt = np.linalg.svd(A)
    X = vt[-1]
    return X[:3] / X[3]


def _determine_similarity(p0: np.ndarray, p1: np.ndarray):
    """Horn similarity transform p1 ~= s R p0 + t (math/transform.h
    determine_transform). Returns (R, s, t) or None."""
    c0 = p0.mean(axis=0)
    c1 = p1.mean(axis=0)
    q0 = p0 - c0
    q1 = p1 - c1
    H = q0.T @ q1
    u, sv, vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    D = np.diag([1.0, 1.0, d])
    R = vt.T @ D @ u.T
    denom = np.sum(q0 * q0)
    if denom < 1e-30:
        return None
    s = np.sum(sv * np.diag(D)) / denom
    t = c1 - s * R @ c0
    return R, s, t
