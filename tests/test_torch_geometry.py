"""The port's rotation, two-view geometry, homography, P3P, triangulation
and RANSAC against mve_tpu's, on seeded numpy inputs, on the CPU.

Tolerances (float32 unless stated): rotation 1e-6; 8-point, rank
constraints and essential decomposition 1e-5 (one float32 SVD each);
homography DLT 1e-4 relative (an SVD of an 8x9 system); P3P poses 1e-3
on the valid roots (a float32 quartic and a 3x3 SVD per root: on some
triples both packages lose digits, so the roots agree to 1e-6 on most
samples but to only 2e-4 on others);
triangulation (float64 numpy in both) 1e-12. The RANSACs draw the same
samples from the same seed: at least 99% of inliers shared, and the
estimate within 1e-4. For P3P both packages pick the same (sample, root)
hypothesis, with the same inlier count and no near tie; its raw pose
carries the float32 quartic's error, which on some triples is 1e-4 to
2e-3 in R (mve_tpu's own pose of that hypothesis moves by as much between
its fused RANSAC program and pose_p3p compiled alone), so the raw poses
are held to R 2e-3 and t 1e-2 there, and the poses refitted in float64
on the shared inliers to 1e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mve_tpu.math import rotation as jrot
from mve_tpu.sfm import fundamental as jfu, homography as jho, p3p as jp3p
from mve_tpu.sfm import ransac as jransac, triangulate as jtri
from mve_tpu.sfm.bundler import incremental as jinc
from mve_tpu.sfm.bundler.common import Track as JTrack, Viewport as JViewport

from mve_tpu_torch.math import rotation as trot
from mve_tpu_torch.sfm import fundamental as tfu, homography as tho, p3p as tp3p
from mve_tpu_torch.sfm import ransac as transac, triangulate as ttri
from mve_tpu_torch.sfm.bundler import incremental as tinc
from mve_tpu_torch.sfm.bundler.common import Track as TTrack, Viewport as TViewport
from mve_tpu_torch.sfm.pose import CameraPose

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def test_rotation_round_trips_and_parity():
    rng = np.random.RandomState(0)
    r = rng.randn(16, 3) * 0.7
    r[0] = 0.0
    R_j = np.asarray(jrot.rodrigues_to_matrix(_j(r)))
    R_t = trot.rodrigues_to_matrix(_t(r)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    # numpy in, numpy out (float64), as mve_tpu's host path.
    np.testing.assert_allclose(trot.rodrigues_to_matrix(r), jrot.rodrigues_to_matrix(r), atol=1e-12)
    np.testing.assert_allclose(trot.matrix_to_rodrigues(R_t.astype(np.float64)), r, atol=1e-5)
    q = trot.matrix_to_quat(R_j.astype(np.float64))
    np.testing.assert_allclose(np.abs(q), np.abs(jrot.matrix_to_quat(R_j.astype(np.float64))), atol=1e-9)
    np.testing.assert_allclose(trot.quat_to_matrix(q), R_j, atol=1e-6)
    np.testing.assert_allclose(trot.skew(r), jrot.skew(r), atol=0)


def test_rodrigues_derivative_at_zero_is_exact():
    """The series branch: d R(r) / d r at r = 0 is the skew generator."""
    from torch.func import jacfwd

    J = jacfwd(trot.rodrigues_to_matrix)(torch.zeros(3, dtype=torch.float64))
    for k in range(3):
        e = np.zeros(3)
        e[k] = 1.0
        np.testing.assert_array_equal(J[..., k].numpy(), trot.skew(e))


def test_fundamental_family():
    rng = np.random.RandomState(1)
    s1, s2 = rng.rand(6, 8, 2), rng.rand(6, 8, 2)
    F_j = np.asarray(jfu.fundamental_least_squares(_j(s1), _j(s2)))
    F_t = tfu.fundamental_least_squares(_t(s1), _t(s2)).numpy()
    # The null vector's sign is free.
    sign = np.sign(np.sum(F_j * F_t, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(F_t * sign, F_j, atol=1e-5)
    E = rng.randn(6, 3, 3)
    np.testing.assert_allclose(tfu.enforce_fundamental_constraints(_t(E)).numpy(),
                               np.asarray(jfu.enforce_fundamental_constraints(_j(E))), atol=1e-5)
    np.testing.assert_allclose(tfu.enforce_essential_constraints(_t(E)).numpy(),
                               np.asarray(jfu.enforce_essential_constraints(_j(E))), atol=1e-5)
    Rs_j, ts_j = jfu.pose_from_essential(_j(E))
    Rs_t, ts_t = tfu.pose_from_essential(_t(E))
    np.testing.assert_allclose(Rs_t.numpy(), np.asarray(Rs_j), atol=1e-5)
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=1e-5)
    p1, p2 = rng.rand(5, 7, 2), rng.rand(5, 7, 2)
    Fs_j, ok_j = jfu.fundamental_7_point(_j(p1), _j(p2))
    Fs_t, ok_t = tfu.fundamental_7_point(_t(p1), _t(p2))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    for F in Fs_t.numpy().reshape(-1, 3, 3)[ok_t.numpy().reshape(-1)]:
        assert abs(np.linalg.det(F / np.abs(F).max())) < 1e-4  # each root is rank 2
    pose1, pose2 = CameraPose(), CameraPose()
    pose1.set_k_matrix(0.9, 0.0, 0.0)
    pose2.set_k_matrix(1.1, 0.0, 0.0)
    pose2.R = trot.rodrigues_to_matrix(np.array([0.1, -0.2, 0.05]))
    pose2.t = np.array([0.5, 0.1, -0.2])
    np.testing.assert_allclose(tfu.fundamental_from_pose(pose1, pose2),
                               jfu.fundamental_from_pose(pose1, pose2), atol=1e-12)


def test_homography_dlt_and_transfer_error():
    rng = np.random.RandomState(2)
    p1, p2 = rng.rand(10, 4, 2), rng.rand(10, 4, 2)
    H_j = np.asarray(jho.homography_dlt(_j(p1), _j(p2)))
    H_t = tho.homography_dlt(_t(p1), _t(p2)).numpy()
    np.testing.assert_allclose(H_t, H_j, rtol=1e-4, atol=1e-4)
    q1, q2 = rng.rand(1, 50, 2), rng.rand(1, 50, 2)
    e_j = np.asarray(jho.symmetric_transfer_error(_j(H_j), _j(q1), _j(q2)))
    e_t = tho.symmetric_transfer_error(_t(H_j), _t(q1), _t(q2)).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4)


def _p3p_scene(rng, n, n_out, extent=1.0):
    """n 2D-3D correspondences in front of a camera, the first n_out
    displaced by 10x-40x the RANSAC threshold, the rest exact."""
    X = (rng.rand(n, 3) * 2 - 1) * extent
    X[:, 2] += 5.0
    R = trot.rodrigues_to_matrix(np.array([0.1, -0.2, 0.05]))
    t = np.array([0.3, -0.1, 0.2])
    pc = X @ R.T + t
    uv = pc[:, :2] / pc[:, 2:] * 0.9
    uv[:n_out] += (0.05 + 0.15 * rng.rand(n_out, 2)) * np.sign(rng.randn(n_out, 2))
    return X, uv, R, t


def test_p3p_solver():
    rng = np.random.RandomState(3)
    X, uv, R, t = _p3p_scene(rng, 60, 0)
    h = np.concatenate([uv / 0.9, np.ones((len(uv), 1))], axis=1)
    bearings = h / np.linalg.norm(h, axis=1, keepdims=True)
    idx = np.array([[0, 1, 2], [3, 4, 5], [10, 20, 30], [7, 17, 37], [40, 50, 59]])
    Rj, tj, vj = jp3p.pose_p3p(_j(X[idx]), _j(bearings[idx]))
    Rt, tt, vt = tp3p.pose_p3p(_t(X[idx]), _t(bearings[idx]))
    vj, vt = np.asarray(vj), vt.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() >= 6
    np.testing.assert_allclose(Rt.numpy()[vt], np.asarray(Rj)[vj], atol=1e-3)
    np.testing.assert_allclose(tt.numpy()[vt], np.asarray(tj)[vj], atol=1e-3)
    # The first triple has a root at the true pose.
    assert min(np.abs(Rt[0, k].numpy() - R).max() for k in range(4) if vt[0, k]) < 1e-3
    c_j = np.asarray(jp3p.cubic_roots_real(_j([1.0, -6.0]), _j([-4.0, 11.0]), _j([4.0, -6.0]))[0])
    c_t = tp3p.cubic_roots_real(_t([1.0, -6.0]), _t([-4.0, 11.0]), _t([4.0, -6.0]))[0].numpy()
    np.testing.assert_allclose(c_t, c_j, atol=1e-5)


def test_triangulation_copies():
    rng = np.random.RandomState(4)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    P2 = np.concatenate([trot.rodrigues_to_matrix(np.array([0.0, 0.2, 0.0])),
                         np.array([[-1.0], [0.0], [0.1]])], axis=1)
    X = rng.rand(20, 3) + np.array([0.0, 0.0, 4.0])
    Xh = np.concatenate([X, np.ones((20, 1))], axis=1)
    x1 = (Xh @ P1.T)[:, :2] / (Xh @ P1.T)[:, 2:]
    x2 = (Xh @ P2.T)[:, :2] / (Xh @ P2.T)[:, 2:]
    out_t = ttri.triangulate_match(x1, x2, np.tile(P1, (20, 1, 1)), np.tile(P2, (20, 1, 1)))
    out_j = jtri.triangulate_match(x1, x2, np.tile(P1, (20, 1, 1)), np.tile(P2, (20, 1, 1)))
    np.testing.assert_allclose(out_t, out_j, atol=1e-12)
    np.testing.assert_allclose(out_t, X, atol=1e-9)
    pos = np.stack([x1, x2], axis=1)
    Ps = np.stack([np.tile(P1, (20, 1, 1)), np.tile(P2, (20, 1, 1))], axis=1)
    np.testing.assert_allclose(ttri.triangulate_tracks_batched(pos, Ps, np.ones((20, 2), bool)),
                               jtri.triangulate_tracks_batched(pos, Ps, np.ones((20, 2), bool)),
                               atol=1e-12)


def test_ransac_homography_same_seed():
    rng = np.random.RandomState(5)
    n = 300
    p1 = rng.rand(n, 2) - 0.5
    H = np.array([[1.1, 0.05, 0.02], [0.03, 0.95, -0.01], [0.1, 0.05, 1.0]])
    x = np.concatenate([p1, np.ones((n, 1))], axis=1) @ H.T
    p2 = x[:, :2] / x[:, 2:]
    p2[:60] += (0.05 + 0.2 * rng.rand(60, 2)) * np.sign(rng.randn(60, 2))
    p2 += rng.randn(n, 2) * 2e-4
    a = jransac.ransac_homography(p1, p2)
    b = transac.ransac_homography(p1, p2, device="cpu")
    shared = len(np.intersect1d(a.inliers, b.inliers))
    assert shared >= 0.99 * max(len(a.inliers), len(b.inliers))
    assert len(b.inliers) == b.score >= 0.95 * (n - 60)
    np.testing.assert_allclose(b.model, a.model, atol=1e-4)


def _p3p_counts(Rs, ts, valid, X, uv, K, threshold=0.005):
    """Inlier count of every (sample, root) hypothesis, flattened as both
    RANSACs flatten them for their argmax, scored alike in float64."""
    Rs, ts = np.asarray(Rs, np.float64), np.asarray(ts, np.float64)
    pc = np.einsum("bkij,nj->bkni", Rs, X) + ts[:, :, None, :]
    proj = np.einsum("ij,bknj->bkni", K, pc)
    err = np.linalg.norm(proj[..., :2] / proj[..., 2:] - uv[None, None], axis=-1)
    inl = (err < threshold) & (pc[..., 2] > 1e-9) & np.asarray(valid)[..., None]
    return inl.sum(axis=-1).reshape(-1)


def _refit_pose(R, t, X, uv, K, iters=8):
    """Gauss-Newton on the reprojection error of (X, uv) in float64 from
    (R, t): R <- rodrigues(w) R, t <- t + dt, central differences."""
    def resid(p):
        pc = X @ (trot.rodrigues_to_matrix(p[:3]) @ R).T + t + p[3:]
        proj = pc @ K.T
        return (proj[:, :2] / proj[:, 2:] - uv).ravel()

    for _ in range(iters):
        J = np.stack([(resid(e) - resid(-e)) / 2e-7 for e in np.eye(6) * 1e-7], axis=1)
        step = np.linalg.lstsq(J, -resid(np.zeros(6)), rcond=None)[0]
        R = trot.rodrigues_to_matrix(step[:3]) @ R
        t = t + step[3:]
    return R, t


@pytest.mark.parametrize("seed,tol_R,tol_t", [(6, 1e-4, 1e-4), (7, 2e-3, 1e-2),
                                              (9, 2e-3, 1e-2)])
def test_ransac_pose_p3p_same_seed(seed, tol_R, tol_t):
    rng = np.random.RandomState(seed)
    X, uv, R, t = _p3p_scene(rng, 250, 50, extent=2.0)
    K = np.diag([0.9, 0.9, 1.0])
    a = jransac.ransac_pose_p3p(X, uv, K)
    b = transac.ransac_pose_p3p(X, uv, K, device="cpu")
    shared = len(np.intersect1d(a.inliers, b.inliers))
    assert len(a.inliers) == len(b.inliers)
    assert shared >= 0.99 * max(len(a.inliers), len(b.inliers))
    np.testing.assert_array_equal(np.sort(b.inliers), np.arange(50, 250))
    # The same hypothesis wins in both: the RANSACs' own draw (RandomState(0),
    # identical in both packages), solved by each package's P3P.
    n = len(X)
    h = np.concatenate([uv, np.ones((n, 1))], axis=1) @ np.linalg.inv(K).T
    bearings = h / np.linalg.norm(h, axis=1, keepdims=True)
    idx = transac._sample_indices(np.random.RandomState(0), n, 3, 1000)
    Rj, tj, vj = jp3p.pose_p3p(_j(X[idx]), _j(bearings[idx]))
    Rt, tt, vt = tp3p.pose_p3p(_t(X[idx]), _t(bearings[idx]))
    cj, ct = _p3p_counts(Rj, tj, vj, X, uv, K), _p3p_counts(Rt, tt, vt, X, uv, K)
    best = int(np.argmax(ct))
    assert int(np.argmax(cj)) == best
    assert cj[best] == ct[best] == len(b.inliers)
    # No near tie: every earlier hypothesis has at least two inliers fewer
    # in both, so no single borderline point could move the choice.
    assert max(cj[:best].max(initial=0), ct[:best].max(initial=0)) <= ct[best] - 2
    # The port returns that hypothesis's own pose.
    np.testing.assert_array_equal(b.R, Rt.numpy().reshape(-1, 3, 3)[best])
    np.testing.assert_array_equal(b.t, tt.numpy().reshape(-1, 3)[best])
    # Its raw pose within the float32 quartic's error (module docstring):
    # no further from mve_tpu's RANSAC pose than twice mve_tpu's own
    # pose_p3p of the same hypothesis is ...
    own_R = np.abs(np.asarray(Rj).reshape(-1, 3, 3)[best] - a.R).max()
    own_t = np.abs(np.asarray(tj).reshape(-1, 3)[best] - a.t).max()
    assert np.abs(b.R - a.R).max() <= 2 * own_R + 1e-5
    assert np.abs(b.t - a.t).max() <= 2 * own_t + 1e-5
    np.testing.assert_allclose(b.R, a.R, atol=tol_R)
    np.testing.assert_allclose(b.t, a.t, atol=tol_t)
    # ... and both refitted on the shared inliers to the same pose.
    keep = np.intersect1d(a.inliers, b.inliers)
    Ra, ta = _refit_pose(a.R, a.t, X[keep], uv[keep], K)
    Rb, tb = _refit_pose(b.R, b.t, X[keep], uv[keep], K)
    np.testing.assert_allclose(Rb, Ra, atol=1e-4)
    np.testing.assert_allclose(tb, ta, atol=1e-4)
    np.testing.assert_allclose(Rb, R, atol=1e-4)
    # min_pad pads the scorer only: the result is the same.
    c = transac.ransac_pose_p3p(X, uv, K, transac.RansacOptions(threshold=0.005, min_pad=1024),
                                device="cpu")
    np.testing.assert_array_equal(c.inliers, b.inliers)
    np.testing.assert_array_equal(c.R, b.R)


def test_ransac_too_few_correspondences():
    with pytest.raises(ValueError):
        transac.ransac_pose_p3p(np.zeros((2, 3)), np.zeros((2, 2)), np.eye(3), device="cpu")
    with pytest.raises(ValueError):
        transac.ransac_homography(np.zeros((3, 2)), np.zeros((3, 2)), device="cpu")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_incremental_writes_min_pad_into_callers_options(pkg):
    """Incremental.initialize writes pose_p3p_opts.min_pad into the
    options object the caller passed (mve_tpu/sfm/bundler/incremental.py:85),
    a reference behaviour the port keeps."""
    inc_mod, Viewport, Track = ((jinc, JViewport, JTrack) if pkg == "jax"
                                else (tinc, TViewport, TTrack))
    opts = inc_mod.IncrementalOptions()
    assert opts.pose_p3p_opts.min_pad == 0
    vps = []
    for n in (70, 300, 5):
        vp = Viewport()
        vp.positions = np.zeros((n, 2), np.float32)
        vp.track_ids = np.full(n, -1, np.int32)
        vps.append(vp)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    inc = inc_mod.Incremental(opts, **kw)
    inc.initialize(vps, [Track()])
    assert opts.pose_p3p_opts.min_pad == 512  # next power of two >= 300
    assert inc.opts is opts
