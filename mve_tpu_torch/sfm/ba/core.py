"""Bundle adjustment on tensors (port of mve_tpu/sfm/ba/core.py).

All functions work on fixed-shape padded tensors:
    intr (C, 3) [f, k0, k1]; trans (C, 3); rot (C, 3, 3); points (P, 3)
    obs (O, 2); cam_idx (O,); pt_idx (O,); obs_valid (O,)

The residual model is the reference's (bundle_adjustment.cc:204-266):
project with R X + t, perspective divide, radial distortion factor
1 + r2 (k0 + k1 r2), scale by the focal length, subtract the observation.
The Jacobian blocks are the closed-form chain rule of that function (the
reference's bundle_adjustment.cc:307-635; mve_tpu takes them by forward
autodiff of the same function, and tests/test_torch_ba.py holds the two
together). torch.func.jacfwd under vmap gave the same blocks, but its
first call in a process took 8 s on the card.

The Schur complement solve is matrix-free: S y = B_damped y - E C^-1 E^T y,
where both E products are batched (O, .) contractions and segment sums.
The segment sums are deterministic: once per BA (ObservationLayout) each
camera and each point gets a padded row of its observations' indices, and
every sum gathers those rows and reduces them with torch.sum. There are no
atomics, so one input gives the same bits on every run. The small batched
products are elementwise products and sums: as einsum they became cuBLAS
batched GEMVs of 2x9 blocks, many times slower on the card.

Nothing here waits for the device except where the host must decide:
PCG reads its stop flag once per block of CG_BLOCK iterations (after the
flag is set, the iterate is frozen by torch.where and the count stops, so
the result and the count are those of mve_tpu's while_loop), and the LM
loop reads its stop flag once per step. The 9x9 preconditioner uses
torch.linalg.inv_ex and torch.linalg.det, neither of which checks an
error code on the host; the 3x3 point blocks use the closed form.
"""

from __future__ import annotations

import numpy as np
import torch

from ...math.rotation import rodrigues_to_matrix

# CG iterations between two reads of the stop flag.
CG_BLOCK = 8


# ---------------------------------------------------------------------------
# deterministic segment sums
# ---------------------------------------------------------------------------

class Segments:
    """Sums of rows grouped by one index array (mve_tpu's
    jax.ops.segment_sum), without atomics.

    A (n, L) table holds, for each group, the indices of its rows in their
    original order, padded with the index of a zero row appended to the
    data; a sum gathers (n, L, ...) and reduces over L. Rows outside
    `valid` are left out: their terms are zero (the BA zeroes the
    Jacobians of padded observations), so the sums are unchanged."""

    def __init__(self, idx: np.ndarray, n: int, device, valid=None):
        idx = np.asarray(idx, np.int64)
        rows = np.arange(len(idx)) if valid is None else np.nonzero(np.asarray(valid))[0]
        order = rows[np.argsort(idx[rows], kind="stable")]
        counts = np.bincount(idx[rows], minlength=n)
        table = np.full((n, max(int(counts.max(initial=0)), 1)), len(idx), np.int64)
        seg = np.repeat(np.arange(n), counts)
        table[seg, np.arange(len(order)) - (np.cumsum(counts) - counts)[seg]] = order
        self.table = torch.from_numpy(table).to(device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(O, ...) rows -> (n, ...) group sums."""
        x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        return x[self.table].sum(dim=1)


class ObservationLayout:
    """The observations grouped by camera and by point, for one BA."""

    def __init__(self, cam_idx, pt_idx, n_cams: int, n_points: int, device, valid=None):
        self.cam = Segments(cam_idx, n_cams, device, valid)
        self.pt = Segments(pt_idx, n_points, device, valid)

    @staticmethod
    def of(cam_idx: torch.Tensor, pt_idx: torch.Tensor, n_cams: int, n_points: int):
        return ObservationLayout(cam_idx.cpu().numpy(), pt_idx.cpu().numpy(),
                                 n_cams, n_points, cam_idx.device)


# ---------------------------------------------------------------------------
# residuals + jacobians
# ---------------------------------------------------------------------------

def _project(intr, trans, rot, points, obs, cam_idx, pt_idx):
    """Per observation: the residual f (O, 2) and what its derivatives
    need: the rotated point q = R X (O, 3), the normalised image point
    u = (x, y) (O, 2), 1 / z, r2 and the distortion factor d."""
    k = intr[cam_idx]
    q = (rot[cam_idx] * points[pt_idx][:, None, :]).sum(-1)
    pc = q + trans[cam_idx]
    inv_z = 1.0 / pc[:, 2:3]
    u = pc[:, 0:2] * inv_z
    r2 = (u * u).sum(-1, keepdim=True)
    d = 1.0 + r2 * (k[:, 1:2] + k[:, 2:3] * r2)
    f = u * d * k[:, 0:1] - obs
    return f, k, q, u, inv_z, r2, d


def _residuals_and_jacobians(intr, trans, rot, points, obs, cam_idx, pt_idx):
    """(f (O,2), Jc (O,2,9), Jp (O,2,3)) with the camera parameters
    [f, k0, k1, t(3), r(3)] (r: a rotation increment about R, at r = 0)."""
    f, k, q, u, inv_z, r2, d = _project(intr, trans, rot, points, obs, cam_idx, pt_idx)
    flen, k0, k1 = k[:, 0:1], k[:, 1:2], k[:, 2:3]
    # d(residual)/d(u): flen (d I + 2 (k0 + 2 k1 r2) u u^T).
    eye2 = torch.eye(2, dtype=f.dtype, device=f.device)
    J_u = flen[:, :, None] * (d[:, :, None] * eye2
                              + 2.0 * (k0 + 2.0 * k1 * r2)[:, :, None]
                              * u[:, :, None] * u[:, None, :])
    # d(u)/d(pc) = [[1/z, 0, -x/z], [0, 1/z, -y/z]].
    zero = torch.zeros_like(inv_z)
    du_dpc = torch.stack([torch.cat([inv_z, zero, -u[:, 0:1] * inv_z], -1),
                          torch.cat([zero, inv_z, -u[:, 1:2] * inv_z], -1)], dim=1)
    J_pc = (J_u[:, :, :, None] * du_dpc[:, None, :, :]).sum(2)          # (O, 2, 3)
    # d(pc)/d(r) = -[q]_x: the increment rotates q by r x q.
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    zq = torch.zeros_like(qx)
    neg_skew_q = torch.stack([torch.stack([zq, qz, -qy], -1),
                              torch.stack([-qz, zq, qx], -1),
                              torch.stack([qy, -qx, zq], -1)], dim=1)
    J_r = (J_pc[:, :, :, None] * neg_skew_q[:, None, :, :]).sum(2)      # (O, 2, 3)
    J_intr = torch.cat([u * d, u * (flen * r2), u * (flen * r2 * r2)], -1)
    Jc = torch.cat([J_intr.reshape(-1, 3, 2).transpose(1, 2), J_pc, J_r], dim=2)
    Jp = (J_pc[:, :, :, None] * rot[cam_idx][:, None, :, :]).sum(2)      # J_pc R
    return f, Jc, Jp


def build_system(intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid,
                 mode: int = 3, fixed_intrinsics: bool = False,
                 layout: ObservationLayout | None = None):
    """Residuals, Jacobian blocks and Hessian blocks of the whole problem.

    Returns a dict with f (O,2), Jc (O,2,9), Jp (O,2,3), B (C,9,9),
    Cb (P,3,3), v (C,9), w (P,3).
    """
    C, P = intr.shape[0], points.shape[0]
    layout = layout or ObservationLayout.of(cam_idx, pt_idx, C, P)
    f, Jc, Jp = _residuals_and_jacobians(intr, trans, rot, points, obs, cam_idx, pt_idx)
    ov = obs_valid.to(f.dtype)
    f = f * ov[:, None]
    Jc = Jc * ov[:, None, None]
    Jp = Jp * ov[:, None, None]
    if not (mode & 1):  # no camera optimisation
        Jc = torch.zeros_like(Jc)
    if not (mode & 2):  # no point optimisation
        Jp = torch.zeros_like(Jp)
    if fixed_intrinsics:
        mask = torch.cat([torch.zeros(3, dtype=f.dtype, device=f.device),
                          torch.ones(6, dtype=f.dtype, device=f.device)])
        Jc = Jc * mask[None, None, :]

    B = layout.cam.sum(_gram(Jc))
    Cb = layout.pt.sum(_gram(Jp))
    v = -layout.cam.sum(_jt_r(Jc, f))
    w = -layout.pt.sum(_jt_r(Jp, f))
    return {"f": f, "Jc": Jc, "Jp": Jp, "B": B, "Cb": Cb, "v": v, "w": w}


def compute_residuals(intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid):
    f = _project(intr, trans, rot, points, obs, cam_idx, pt_idx)[0]
    return f * obs_valid.to(f.dtype)[:, None]


def compute_mse(f, num_valid):
    """MSE per observation = sum(f^2) / num_observations
    (bundle_adjustment.cc compute_mse divides by F.size()/2)."""
    return torch.sum(f * f) / torch.clamp(num_valid, min=1)


# ---------------------------------------------------------------------------
# 3x3 closed-form inverse (batched)
# ---------------------------------------------------------------------------

def _inv3x3(M):
    """Batched adjugate inverse; singular blocks -> zeros (those are the
    blocks of points without observations, whose w is zero too)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    ok = torch.abs(det) > 1e-30
    det_safe = torch.where(ok, det, 1.0)
    adj = torch.stack([torch.stack([A, B, Cc], dim=-1),
                       torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    inv = adj / det_safe[..., None, None]
    return torch.where(ok[..., None, None], inv, 0.0)


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _damp_diag(M, trr):
    """Multiply the diagonal by (1 + 1/trust_region_radius)
    (ba_linear_solver.cc:177-179)."""
    return M + M * _eye(M.shape[-1], M) * (1.0 / trr)


def _bmv(M, x):
    """Batched matrix-vector product (n, i, j) x (n, j) -> (n, i)."""
    return (M * x[:, None, :]).sum(-1)


def _jt_r(J, r):
    """J^T r per observation: (O, 2, k) x (O, 2) -> (O, k)."""
    return (J * r[:, :, None]).sum(1)


def _gram(J):
    """J^T J per observation: (O, 2, k) -> (O, k, k)."""
    return (J[:, :, :, None] * J[:, :, None, :]).sum(1)


def _nonzero(x):
    return torch.where(torch.abs(x) < 1e-30, 1e-30, x)


# ---------------------------------------------------------------------------
# preconditioned conjugate gradients
# ---------------------------------------------------------------------------

def _pcg(S_mul, precond, rhs, max_it: int):
    """PCG from y = 0 (ba_conjugate_gradient.h:100-208 semantics).

    Stops on ||r||^2 < max(1e-20, 100 eps^2 ||r0||^2) (the reference's
    absolute 1e-20 is out of float32's reach, so also machine precision
    relative to the start) or after max_it iterations. Returns (y, count)
    with count an int32 tensor; the stop flag is read on the host once per
    block of CG_BLOCK iterations."""
    y = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    d = z
    rz = torch.sum(r * z)
    rr0 = torch.sum(r * r)
    eps = torch.finfo(rhs.dtype).eps
    tol = torch.clamp(rr0 * (eps * eps * 100.0), min=1e-20)
    done = rr0 < tol
    count = torch.zeros((), dtype=torch.int32, device=rhs.device)
    it = 0
    while it < max_it and not bool(done):
        for _ in range(min(CG_BLOCK, max_it - it)):
            Ad = S_mul(d)
            alpha = rz / _nonzero(torch.sum(d * Ad))
            y_n = y + alpha * d
            r_n = r - alpha * Ad
            rr = torch.sum(r_n * r_n)
            z = precond(r_n)
            rz_n = torch.sum(r_n * z)
            beta = rz_n / _nonzero(rz)
            d_n = z + beta * d
            active = ~done
            y = torch.where(active, y_n, y)
            r = torch.where(active, r_n, r)
            d = torch.where(active, d_n, d)
            rz = torch.where(active, rz_n, rz)
            count = count + active.to(torch.int32)
            done = done | (rr < tol)
        it += CG_BLOCK
    return y, count


# ---------------------------------------------------------------------------
# Schur-complement PCG (matrix-free)
# ---------------------------------------------------------------------------

def solve_schur(Jc, Jp, cam_idx, pt_idx, B, Cb, v, w, trr, cg_max_iter: int = 1000,
                layout: ObservationLayout | None = None):
    """Solve the damped normal equations through the Schur complement on
    the reduced camera system, block-Jacobi (damped B) preconditioned.

    Returns (delta_cam (C,9), delta_pt (P,3), pred_decrease, num_iters).
    """
    C, P = B.shape[0], Cb.shape[0]
    layout = layout or ObservationLayout.of(cam_idx, pt_idx, C, P)
    B_d = _damp_diag(B, trr)
    C_inv = _inv3x3(_damp_diag(Cb, trr))
    # Preconditioner: inverse of the damped B blocks; singular (padded or
    # unused camera) blocks -> identity so CG stays finite.
    singular = torch.abs(torch.linalg.det(B_d)) < 1e-20
    M_inv, _ = torch.linalg.inv_ex(B_d + _eye(9, B) * torch.where(singular, 1.0, 0.0)[:, None, None])

    def E_T_y(y):
        """(C,9) -> (P,3): per point, the sum of Jp^T (Jc y[cam])."""
        return layout.pt.sum(_jt_r(Jp, _bmv(Jc, y[cam_idx])))

    def E_z(z):
        """(P,3) -> (C,9): per camera, the sum of Jc^T (Jp z[point])."""
        return layout.cam.sum(_jt_r(Jc, _bmv(Jp, z[pt_idx])))

    def S_mul(y):
        return _bmv(B_d, y) - E_z(_bmv(C_inv, E_T_y(y)))

    rhs = v - E_z(_bmv(C_inv, w))
    delta_y, n_iter = _pcg(S_mul, lambda r: _bmv(M_inv, r), rhs, min(cg_max_iter, 9 * C))
    # Back-substitution: delta_z = C^-1 (w - E^T delta_y).
    delta_z = _bmv(C_inv, w - E_T_y(delta_y))

    # Predicted error decrease (ba_linear_solver.cc:230-236):
    # dy . (B_diag dy / trr + v) + dz . (C_diag dz / trr + w)
    B_diag = B * _eye(9, B)
    C_diag = Cb * _eye(3, Cb)
    pred = torch.sum(delta_y * (_bmv(B_diag, delta_y) / trr + v))
    pred = pred + torch.sum(delta_z * (_bmv(C_diag, delta_z) / trr + w))
    return delta_y, delta_z, pred, n_iter


def solve_cameras_only(Jc, cam_idx, B, v, trr, cg_max_iter: int = 1000):
    """BA_CAMERAS mode: CG on the damped camera system with the scalar
    diagonal as preconditioner (ba_linear_solver.cc:245-313,
    block_size=0). With the points fixed the system is B itself."""
    C = B.shape[0]
    B_d = _damp_diag(B, trr)
    diag = torch.diagonal(B_d, dim1=-2, dim2=-1)  # (C, 9)
    pre = torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 0.0)
    y, n_iter = _pcg(lambda d: _bmv(B_d, d), lambda r: pre * r, v, min(cg_max_iter, 9 * C))
    B_diag = B * _eye(9, B)
    pred = torch.sum(y * (_bmv(B_diag, y) / trr + v))
    return y, pred, n_iter


def solve_points_only(Cb, w, trr):
    """BA_POINTS mode: direct damped 3x3 block solves
    (ba_linear_solver.cc:296-302)."""
    C_inv = _inv3x3(_damp_diag(Cb, trr))
    z = _bmv(C_inv, w)
    C_diag = Cb * _eye(3, Cb)
    pred = torch.sum(z * (_bmv(C_diag, z) / trr + w))
    return z, pred


# ---------------------------------------------------------------------------
# parameter update (bundle_adjustment.cc:640-697)
# ---------------------------------------------------------------------------

def apply_update(intr, trans, rot, points, delta_cam, delta_pt,
                 fixed_intrinsics: bool = False):
    new_intr = intr if fixed_intrinsics else intr + delta_cam[:, 0:3]
    new_trans = trans + delta_cam[:, 3:6]
    R_upd = rodrigues_to_matrix(delta_cam[:, 6:9])
    new_rot = R_upd @ rot
    return new_intr, new_trans, new_rot, points + delta_pt


# ---------------------------------------------------------------------------
# the LM loop
# ---------------------------------------------------------------------------

def lm_optimize(intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid, num_valid,
                mode: int = 3, fixed_intrinsics: bool = False,
                max_iters: int = 50, cg_max_iter: int = 1000,
                lm_delta_threshold: float = 1e-4, lm_mse_threshold: float = 1e-8,
                layout: ObservationLayout | None = None):
    """The LM trust-region loop of mve_tpu's lm_optimize_device
    (bundle_adjustment.cc:73-201): trust region 1000 at the start, halved
    on a failed step, grown by the gain-ratio rule on success; stops on the
    delta-MSE ratio, the MSE threshold or max_iters.

    Every update is a tensor op as in mve_tpu's while_loop body (a failed
    step keeps the parameters through torch.where); the host reads the
    stop flag once per step. Returns (intr, trans, rot, points, status)
    with status = [initial_mse, final_mse, lm_iters, lm_success, lm_fail,
    cg_iters] as a tensor of intr's dtype.
    """
    dtype = intr.dtype
    C, P = intr.shape[0], points.shape[0]
    layout = layout or ObservationLayout.of(cam_idx, pt_idx, C, P)
    mse0 = compute_mse(compute_residuals(intr, trans, rot, points, obs, cam_idx, pt_idx,
                                         obs_valid), num_valid)
    trr = torch.tensor(1000.0, dtype=dtype, device=intr.device)
    mse = mse0
    done = mse0 < lm_mse_threshold
    zero = torch.zeros((), dtype=torch.int32, device=intr.device)
    n_ok, n_fail, n_cg = zero, zero, zero
    it = 0
    while it < max_iters and not bool(done):
        sys = build_system(intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid,
                           mode=mode, fixed_intrinsics=fixed_intrinsics, layout=layout)
        if mode == 3:
            dc, dp, pred, cg = solve_schur(sys["Jc"], sys["Jp"], cam_idx, pt_idx, sys["B"],
                                           sys["Cb"], sys["v"], sys["w"], trr,
                                           cg_max_iter=cg_max_iter, layout=layout)
        elif mode == 1:
            dc, pred, cg = solve_cameras_only(sys["Jc"], cam_idx, sys["B"], sys["v"], trr,
                                              cg_max_iter=cg_max_iter)
            dp = torch.zeros_like(points)
        else:
            dp, pred = solve_points_only(sys["Cb"], sys["w"], trr)
            dc = torch.zeros((C, 9), dtype=dtype, device=intr.device)
            cg = zero
        ni, nt, nr, npts = apply_update(intr, trans, rot, points, dc, dp,
                                        fixed_intrinsics=fixed_intrinsics)
        new_mse = compute_mse(compute_residuals(ni, nt, nr, npts, obs, cam_idx, pt_idx,
                                                obs_valid), num_valid)
        delta_mse = mse - new_mse
        success = delta_mse > 0.0

        gain = delta_mse * num_valid / torch.where(pred == 0.0, 1.0, pred)
        tr_up = 1.0 / torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
        trr = torch.where(success, trr * tr_up, trr * 0.5)

        intr = torch.where(success, ni, intr)
        trans = torch.where(success, nt, trans)
        rot = torch.where(success, nr, rot)
        points = torch.where(success, npts, points)
        delta_ratio = 1.0 - new_mse / torch.clamp(mse, min=1e-300)
        mse = torch.where(success, new_mse, mse)
        done = (success & (delta_ratio < lm_delta_threshold)) | (mse < lm_mse_threshold)
        n_ok = n_ok + success.to(torch.int32)
        n_fail = n_fail + (~success).to(torch.int32)
        n_cg = n_cg + cg
        it += 1
    status = torch.stack([mse0, mse, torch.tensor(float(it), dtype=dtype, device=intr.device),
                          n_ok.to(dtype), n_fail.to(dtype), n_cg.to(dtype)])
    return intr, trans, rot, points, status
