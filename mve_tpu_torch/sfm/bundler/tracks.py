"""Track building by ID propagation (reference: libs/sfm/bundler_tracks.cc).

Same algorithm as the reference: iterate pairwise matches, propagate or
unify track IDs, remove tracks with multiple features in one view, and
average feature colors. Irregular graph work stays on host (cheap).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .common import FeatureReference, Track, TwoViewMatching, Viewport


@dataclasses.dataclass
class TracksOptions:
    verbose: bool = False


class Tracks:
    def __init__(self, options: Optional[TracksOptions] = None):
        self.opts = options or TracksOptions()

    def compute(self, matching: List[TwoViewMatching],
                viewports: List[Viewport]) -> List[Track]:
        for vp in viewports:
            vp.track_ids = np.full(len(vp.positions), -1, np.int32)

        tracks: List[Track] = []
        for tvm in matching:
            vp1 = viewports[tvm.view_1_id]
            vp2 = viewports[tvm.view_2_id]
            for f1, f2 in tvm.matches:
                tid1 = int(vp1.track_ids[f1])
                tid2 = int(vp2.track_ids[f2])
                if tid1 == -1 and tid2 == -1:
                    vp1.track_ids[f1] = len(tracks)
                    vp2.track_ids[f2] = len(tracks)
                    t = Track()
                    t.features.append(FeatureReference(tvm.view_1_id, int(f1)))
                    t.features.append(FeatureReference(tvm.view_2_id, int(f2)))
                    tracks.append(t)
                elif tid1 == -1:
                    vp1.track_ids[f1] = tid2
                    tracks[tid2].features.append(FeatureReference(tvm.view_1_id, int(f1)))
                elif tid2 == -1:
                    vp2.track_ids[f2] = tid1
                    tracks[tid1].features.append(FeatureReference(tvm.view_2_id, int(f2)))
                elif tid1 == tid2:
                    pass
                else:
                    self._unify_tracks(tid1, tid2, tracks, viewports)

        num_invalid = self._remove_invalid_tracks(viewports, tracks)
        if self.opts.verbose:
            print(f"Removed {num_invalid} tracks with conflicts.")

        # Average track colors (bundler_tracks.cc:128-145).
        for track in tracks:
            acc = np.zeros(3, np.float64)
            for ref in track.features:
                acc += viewports[ref.view_id].colors[ref.feature_id]
            track.color = np.clip(acc / max(len(track.features), 1) + 0.5, 0, 255).astype(np.uint8)
        return tracks

    @staticmethod
    def _unify_tracks(tid1: int, tid2: int, tracks: List[Track],
                      viewports: List[Viewport]) -> None:
        """Merge the smaller track into the larger (bundler_tracks.cc:28-46)."""
        if len(tracks[tid1].features) < len(tracks[tid2].features):
            tid1, tid2 = tid2, tid1
        for ref in tracks[tid2].features:
            viewports[ref.view_id].track_ids[ref.feature_id] = tid1
        tracks[tid1].features.extend(tracks[tid2].features)
        tracks[tid2].features = []

    @staticmethod
    def _remove_invalid_tracks(viewports: List[Viewport],
                               tracks: List[Track]) -> int:
        """Drop empty tracks and tracks with several features in one view
        (bundler_tracks.cc:150-209)."""
        delete = np.zeros(len(tracks), bool)
        for i, track in enumerate(tracks):
            if not track.features:
                delete[i] = True
                continue
            seen = set()
            for ref in track.features:
                if ref.view_id in seen:
                    delete[i] = True
                    break
                seen.add(ref.view_id)
        id_map = np.full(len(tracks), -1, np.int64)
        id_map[~delete] = np.arange(int((~delete).sum()))
        for vp in viewports:
            valid = vp.track_ids >= 0
            vp.track_ids[valid] = id_map[vp.track_ids[valid]]
        kept = [t for i, t in enumerate(tracks) if not delete[i]]
        n_removed = int(delete.sum())
        tracks[:] = kept
        return n_removed
