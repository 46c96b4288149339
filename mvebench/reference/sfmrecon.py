"""The plain reference of sfmrecon --skip-sfm: the true correspondences of
the benchmark's scene.

The scene is two planes seen by cameras the benchmark made, so where a
keypoint of one view lands in another is known exactly: cast the ray of
the keypoint's position to the visible plane, test whether the other
view sees that point (in front, inside its image, not behind the near
patch), and project it there. This module reads each prebundle.sfm the
window wrote with a parser of its own, puts every match's two keypoints
back on the pixels of the image the features were computed on (MVE's
sfmrecon halves an image until it has at most max_pixels pixels, and
normalises positions to centre (0, 0) and larger side 1), and judges
the matches in float64 against the benchmark's own cameras. It imports
nothing of the program.

Numbers read per prebundle (the workload file names those it compares,
each against its limit; a call's prebundle fails where one is above
it, and each number's check is its worst over the window's calls):
- match_bad_share: of all the matches, the share whose surface point
  the second view does not see, or whose transfer misses the second
  keypoint by more than `transfer_px` pixels of the feature image;
- match_err_median: the median transfer error, in feature-image pixels,
  over the matches whose point the second view sees (the image's larger
  side where it sees none);
- missed_pair_share: of the pairs that overlap (at least
  `overlap_share` of the first view's pixels, on a coarse grid, seen by
  the second), the share with fewer than `min_pair_matches` correct
  matches, a pair missing from the prebundle counting 0;
- match_shortfall: max(0, 1 - median correct matches over the
  overlapping pairs / `pair_matches_floor`), so that a change which
  finds fewer features or fewer matches fails here.
A prebundle that is missing, cannot be parsed, holds another number of
views, or has a match naming a feature it does not hold, has failed.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from mvebench.harness import scene as gen

PREBUNDLE_SIGNATURE = b"MVE_PREBUNDLE\n"
OVERLAP_GRID = 48          # grid points across the first view's larger side


def read_prebundle(path: str):
    """(positions, matches) of a prebundle.sfm (MVE's
    bundler_common.cc layout, little-endian): one (n, 2) float32 array
    of normalised positions a view, and {(view a, view b): (m, 2) int32
    feature indices}."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PREBUNDLE_SIGNATURE):
        raise IOError(f"{path}: not a prebundle")
    off = len(PREBUNDLE_SIGNATURE)

    def ints(n):
        nonlocal off
        out = np.frombuffer(data, "<i4", n, off)
        off += 4 * n
        return out

    positions = []
    for _ in range(int(ints(1)[0])):
        n = int(ints(1)[0])
        positions.append(np.frombuffer(data, "<f4", 2 * n, off).reshape(n, 2).copy())
        off += 8 * n
        n_colours = int(ints(1)[0])         # colours: not judged
        off += 3 * n_colours
    matches = {}
    for _ in range(int(ints(1)[0])):
        a, b, n = (int(x) for x in ints(3))
        matches[(a, b)] = ints(2 * n).reshape(n, 2).copy()
    if off != len(data):
        raise IOError(f"{path}: {len(data) - off} bytes after the matches")
    return positions, matches


def feature_image(w: int, h: int, max_pixels: int):
    """(width, height, factor) of the image sfmrecon computes features on:
    halved, rounding up, until it has at most max_pixels pixels; a
    feature-image coordinate times factor is a full-size one."""
    factor = 1
    while w * h > max_pixels:
        w, h, factor = (w + 1) // 2, (h + 1) // 2, factor * 2
    return w, h, factor


def to_pixels(pos: np.ndarray, fw: int, fh: int) -> np.ndarray:
    """Normalised positions -> continuous feature-image coordinates (a
    pixel's centre at +0.5): the inverse of (x + 0.5 - w/2) / max(w, h)."""
    return pos.astype(np.float64) * max(fw, fh) + np.array([fw / 2.0, fh / 2.0])


def surface_points(cam, uv: np.ndarray, w: int, h: int):
    """The points where the rays through continuous full-size image
    coordinates uv (n, 2) meet the visible surface: (n, 3) and whether
    each lies on the near patch."""
    pix = np.c_[uv, np.ones(len(uv))]
    dirs = pix @ np.linalg.inv(cam.K(w, h)).T @ cam.R
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = torch.from_numpy(dirs)
    c = torch.from_numpy(cam.centre)
    depth, _, _, near = gen.surface_hits(d, c, torch)
    return cam.centre + depth.numpy()[:, None] * dirs, near.numpy()


def project(cam, pts: np.ndarray, w: int, h: int) -> np.ndarray:
    """Continuous full-size image coordinates of world points."""
    proj = (pts @ cam.R.T + cam.t) @ cam.K(w, h).T
    return proj[:, :2] / proj[:, 2:3]


def overlapping_pairs(cams: list, w: int, h: int, share: float) -> list:
    """The pairs (a, b), a < b, where b sees at least `share` of a's
    pixels, sampled on a grid of OVERLAP_GRID points across the larger
    side."""
    step = max(w, h) / OVERLAP_GRID
    xs = np.arange(step / 2, w, step)
    ys = np.arange(step / 2, h, step)
    uv = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    out = []
    for a in range(len(cams)):
        pts, near = surface_points(cams[a], uv, w, h)
        for b in range(a + 1, len(cams)):
            if gen.seen_by(cams[b], pts, near, w, h).mean() >= share:
                out.append((a, b))
    return out


def transfer(cams: list, positions: list, a: int, b: int, m: np.ndarray, geo: dict):
    """(seen, err) of pair (a, b)'s matches m: whether b sees the surface
    point of a's keypoint, and how far its projection in b lies from b's
    keypoint, in feature-image pixels."""
    fw, fh, factor = geo["fw"], geo["fh"], geo["factor"]
    w, h = geo["w"], geo["h"]
    ua = to_pixels(positions[a][m[:, 0]], fw, fh) * factor
    ub = to_pixels(positions[b][m[:, 1]], fw, fh)
    pts, near = surface_points(cams[a], ua, w, h)
    seen = gen.seen_by(cams[b], pts, near, w, h)
    err = np.linalg.norm(project(cams[b], pts, w, h) / factor - ub, axis=1)
    return seen, err


def numbers(cams: list, positions: list, matches: dict, geo: dict, check: dict,
            overlap: list) -> dict:
    """A prebundle's numbers (see the module docstring)."""
    seen_all, err_all, correct = [], [], {}
    for (a, b), m in matches.items():
        if len(m) == 0:
            correct[(a, b)] = 0
            continue
        seen, err = transfer(cams, positions, a, b, m, geo)
        seen_all.append(seen)
        err_all.append(err)
        correct[(a, b)] = int((seen & (err <= check["transfer_px"])).sum())
    seen = np.concatenate(seen_all) if seen_all else np.zeros(0, bool)
    err = np.concatenate(err_all) if err_all else np.zeros(0)
    good = seen & (err <= check["transfer_px"])
    per_pair = np.array([correct.get(p, 0) for p in overlap])
    missed = per_pair < check["min_pair_matches"]
    median_correct = float(np.median(per_pair)) if len(per_pair) else 0.0
    return {"match_bad_share": float(1.0 - good.mean()) if len(good) else 1.0,
            "match_err_median": float(np.median(err[seen])) if seen.any()
            else float(max(geo["fw"], geo["fh"])),
            "missed_pair_share": float(missed.mean()) if len(per_pair) else 0.0,
            "match_shortfall": max(0.0, 1.0 - median_correct / check["pair_matches_floor"]),
            "matches": int(len(good)), "median_correct_per_pair": median_correct,
            "least_correct_per_pair": int(per_pair.min()) if len(per_pair) else 0,
            "overlapping_pairs": len(overlap), "unseen": int((~seen).sum()),
            "err_p99": float(np.percentile(err[seen], 99)) if seen.any() else None,
            "err_max": float(err[seen].max()) if seen.any() else None}


def geometry(cfg: dict, workload: dict) -> dict:
    w, h = cfg["width"], cfg["height"]
    fw, fh, factor = feature_image(w, h, workload["app"]["max_pixels"])
    return {"w": w, "h": h, "fw": fw, "fh": fh, "factor": factor}


def judge(cams: list, cfg: dict, workload: dict, paths: list, replace=None):
    """(checks, attempted, failed, per-prebundle numbers) over the
    prebundles at `paths` (one a call; a call that wrote none fails).
    replace, where given, maps (positions, matches) to the matches that
    take the program's place (the control). Identical files are judged
    once."""
    check = workload["check"]
    limits = workload["limits"]
    geo = geometry(cfg, workload)
    overlap = overlapping_pairs(cams, geo["w"], geo["h"], check["overlap_share"])
    worst = dict.fromkeys(limits, 0.0)
    failed, details, seen_files = 0, [], {}
    for path in paths:
        nums = None
        try:
            with open(path, "rb") as f:
                key = hashlib.sha256(f.read()).hexdigest()
        except OSError:
            key = None
        if key is not None and key in seen_files:
            nums = seen_files[key]
        elif key is not None:
            try:
                positions, matches = read_prebundle(path)
                if len(positions) == len(cams):
                    if replace is not None:
                        matches = replace(positions, matches)
                    nums = numbers(cams, positions, matches, geo, check, overlap)
            except (OSError, ValueError, IndexError):
                # Unreadable, or a match that names a view or feature
                # the file does not hold.
                nums = None
            seen_files[key] = nums
        details.append(nums)
        if nums is None or any(nums[k] > limits[k] for k in limits):
            failed += 1
            if nums is None:
                continue
        for k in limits:
            worst[k] = max(worst[k], nums[k])
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, len(paths), failed, details


def epipolar_control(cams: list, cfg: dict, workload: dict):
    """The control: each match's keypoint in the second view replaced by
    the nearest other keypoint of that view (more than transfer_px from
    it in the feature image) that lies within RANSAC's threshold of the
    true epipolar line of the first keypoint, in normalised coordinates;
    a match with no such keypoint is dropped. Such matches pass the
    fundamental-matrix test the program's RANSAC applies, yet are not
    the correspondence the configuration guarantees. Returns the
    `replace` function judge() takes."""
    geo = geometry(cfg, workload)
    thr = workload["check"]["ransac_threshold"]
    fw, fh = geo["fw"], geo["fh"]

    def fundamental(a, b):
        """F with q_b^T F q_a = 0 for normalised positions q (q = flen x / z
        in camera coordinates, principal point at the centre)."""
        ca, cb = cams[a], cams[b]
        R = cb.R @ ca.R.T
        t = cb.t - R @ ca.t
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        Ka = np.diag([1 / ca.flen, 1 / ca.flen, 1.0])
        Kb = np.diag([1 / cb.flen, 1 / cb.flen, 1.0])
        return Kb @ (tx @ R) @ Ka

    def replace(positions, matches):
        out = {}
        for (a, b), m in matches.items():
            qa = np.c_[positions[a][m[:, 0]].astype(np.float64), np.ones(len(m))]
            qb = np.c_[positions[b].astype(np.float64), np.ones(len(positions[b]))]
            lines = qa @ fundamental(a, b).T                       # (M, 3)
            lines /= np.linalg.norm(lines[:, :2], axis=1, keepdims=True)
            pix_b = to_pixels(positions[b], fw, fh)
            new = []
            for k0 in range(0, len(m), 512):
                dist = np.abs(lines[k0:k0 + 512] @ qb.T)             # (chunk, n_b)
                own = pix_b[m[k0:k0 + 512, 1]]
                gap = np.linalg.norm(pix_b[None] - own[:, None], axis=2)
                gap[(dist > thr) | (gap <= workload["check"]["transfer_px"])] = np.inf
                j = gap.argmin(axis=1)
                ok = np.isfinite(gap[np.arange(len(j)), j])
                new.append(np.c_[m[k0:k0 + 512, 0][ok], j[ok]])
            out[(a, b)] = np.concatenate(new).astype(np.int32) if new else m[:0]
        return out

    return replace
