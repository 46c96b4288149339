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

The observations may be split into shards (ObservationShards; the
shards of a mesh, parallel/distributed_ba.py): the work on observations
then runs shard by shard and each segment sum is the reduction of the
shards' partial sums, while everything on cameras, points and scalars is
computed once, as on one device. The unsharded BA is a one-shard mesh,
whose partial is the sum.

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
from ...parallel.mesh import Mesh

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


class ObservationShards:
    """The observations of one BA in shards, and how their sums add up.

    Each shard holds its rows of (obs, cam_idx, pt_idx, obs_valid) on its
    device with its ObservationLayout. Work on observations runs shard by
    shard; a sum over observations is the mesh's reduce_sum of the
    shards' partial sums, added on the replicated values' device. The
    unsharded BA is a one-shard mesh, whose partial is the sum: the same
    operations."""

    def __init__(self, shards, mesh: Mesh):
        self.shards = list(shards)
        self.mesh = mesh

    @classmethod
    def single(cls, obs, cam_idx, pt_idx, obs_valid, n_cams, n_points, layout=None):
        layout = layout or ObservationLayout.of(cam_idx, pt_idx, n_cams, n_points)
        return cls([Shard(obs, cam_idx, pt_idx, obs_valid, layout)], Mesh([cam_idx.device]))

    def sum(self, partials):
        """The total of per-shard partials (tensors, or tuples of them)."""
        return self.mesh.reduce_sum(partials)


class Shard:
    """One shard's observations and their grouping."""

    def __init__(self, obs, cam_idx, pt_idx, obs_valid, layout: ObservationLayout):
        self.obs, self.cam_idx, self.pt_idx, self.obs_valid = obs, cam_idx, pt_idx, obs_valid
        self.layout = layout
        self.device = cam_idx.device


def _on(device, *tensors):
    return [t.to(device) for t in tensors]


def build_system_sharded(params, shards: ObservationShards, mode: int = 3,
                         fixed_intrinsics: bool = False):
    """build_system over shards: ([(f, Jc, Jp)] per shard, B, Cb, v, w),
    the four Hessian and gradient sums reduced as one."""
    per, partials = [], []
    for s in shards.shards:
        intr, trans, rot, points = _on(s.device, *params)
        f, Jc, Jp = _residuals_and_jacobians(intr, trans, rot, points, s.obs, s.cam_idx,
                                             s.pt_idx)
        ov = s.obs_valid.to(f.dtype)
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
        per.append((f, Jc, Jp))
        partials.append((s.layout.cam.sum(_gram(Jc)), s.layout.pt.sum(_gram(Jp)),
                         s.layout.cam.sum(_jt_r(Jc, f)), s.layout.pt.sum(_jt_r(Jp, f))))
    B, Cb, v, w = shards.sum(partials)
    return per, B, Cb, -v, -w


def build_system(intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid,
                 mode: int = 3, fixed_intrinsics: bool = False,
                 layout: ObservationLayout | None = None):
    """Residuals, Jacobian blocks and Hessian blocks of the whole problem.

    Returns a dict with f (O,2), Jc (O,2,9), Jp (O,2,3), B (C,9,9),
    Cb (P,3,3), v (C,9), w (P,3).
    """
    shards = ObservationShards.single(obs, cam_idx, pt_idx, obs_valid, intr.shape[0],
                                      points.shape[0], layout)
    ((f, Jc, Jp),), B, Cb, v, w = build_system_sharded(
        (intr, trans, rot, points), shards, mode, fixed_intrinsics)
    return {"f": f, "Jc": Jc, "Jp": Jp, "B": B, "Cb": Cb, "v": v, "w": w}


def compute_residuals(intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid):
    f = _project(intr, trans, rot, points, obs, cam_idx, pt_idx)[0]
    return f * obs_valid.to(f.dtype)[:, None]


def compute_mse(f, num_valid):
    """MSE per observation = sum(f^2) / num_observations
    (bundle_adjustment.cc compute_mse divides by F.size()/2)."""
    return torch.sum(f * f) / torch.clamp(num_valid, min=1)


def mse_sharded(params, shards: ObservationShards, num_valid):
    """compute_mse of compute_residuals, each shard's sum of squares
    reduced."""
    parts = []
    for s in shards.shards:
        f = compute_residuals(*_on(s.device, *params), s.obs, s.cam_idx, s.pt_idx, s.obs_valid)
        parts.append(torch.sum(f * f))
    return shards.sum(parts) / torch.clamp(num_valid, min=1)


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

def solve_schur_sharded(per, shards: ObservationShards, B, Cb, v, w, trr,
                        cg_max_iter: int = 1000):
    """solve_schur over shards, with per = [(f, Jc, Jp)] of each shard as
    build_system_sharded gives them: each E product is the shards'
    partial segment sums, reduced. Everything on (C, 9) and (P, 3) is
    replicated."""
    B_d = _damp_diag(B, trr)
    C_inv = _inv3x3(_damp_diag(Cb, trr))
    # Preconditioner: inverse of the damped B blocks; singular (padded or
    # unused camera) blocks -> identity so CG stays finite.
    singular = torch.abs(torch.linalg.det(B_d)) < 1e-20
    M_inv, _ = torch.linalg.inv_ex(B_d + _eye(9, B) * torch.where(singular, 1.0, 0.0)[:, None, None])
    pairs = [(s, Jc, Jp) for s, (_, Jc, Jp) in zip(shards.shards, per)]

    def E_T_y(y):
        """(C,9) -> (P,3): per point, the sum of Jp^T (Jc y[cam])."""
        return shards.sum([s.layout.pt.sum(_jt_r(Jp, _bmv(Jc, y.to(s.device)[s.cam_idx])))
                           for s, Jc, Jp in pairs])

    def E_z(z):
        """(P,3) -> (C,9): per camera, the sum of Jc^T (Jp z[point])."""
        return shards.sum([s.layout.cam.sum(_jt_r(Jc, _bmv(Jp, z.to(s.device)[s.pt_idx])))
                           for s, Jc, Jp in pairs])

    def S_mul(y):
        return _bmv(B_d, y) - E_z(_bmv(C_inv, E_T_y(y)))

    rhs = v - E_z(_bmv(C_inv, w))
    delta_y, n_iter = _pcg(S_mul, lambda r: _bmv(M_inv, r), rhs, min(cg_max_iter, 9 * B.shape[0]))
    # Back-substitution: delta_z = C^-1 (w - E^T delta_y).
    delta_z = _bmv(C_inv, w - E_T_y(delta_y))

    # Predicted error decrease (ba_linear_solver.cc:230-236):
    # dy . (B_diag dy / trr + v) + dz . (C_diag dz / trr + w)
    B_diag = B * _eye(9, B)
    C_diag = Cb * _eye(3, Cb)
    pred = torch.sum(delta_y * (_bmv(B_diag, delta_y) / trr + v))
    pred = pred + torch.sum(delta_z * (_bmv(C_diag, delta_z) / trr + w))
    return delta_y, delta_z, pred, n_iter


def solve_schur(Jc, Jp, cam_idx, pt_idx, B, Cb, v, w, trr, cg_max_iter: int = 1000,
                layout: ObservationLayout | None = None):
    """Solve the damped normal equations through the Schur complement on
    the reduced camera system, block-Jacobi (damped B) preconditioned.

    Returns (delta_cam (C,9), delta_pt (P,3), pred_decrease, num_iters).
    """
    shards = ObservationShards.single(None, cam_idx, pt_idx, None, B.shape[0], Cb.shape[0],
                                      layout)
    return solve_schur_sharded([(None, Jc, Jp)], shards, B, Cb, v, w, trr, cg_max_iter)


def solve_cameras_only(B, v, trr, cg_max_iter: int = 1000):
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
    (bundle_adjustment.cc:73-201) on one device: lm_optimize_sharded
    with the observations in one shard."""
    shards = ObservationShards.single(obs, cam_idx, pt_idx, obs_valid, intr.shape[0],
                                      points.shape[0], layout)
    return lm_optimize_sharded(intr, trans, rot, points, shards, num_valid, mode=mode,
                               fixed_intrinsics=fixed_intrinsics, max_iters=max_iters,
                               cg_max_iter=cg_max_iter, lm_delta_threshold=lm_delta_threshold,
                               lm_mse_threshold=lm_mse_threshold)


# mve_tpu's name for the loop on one device.
lm_optimize_device = lm_optimize


def _lm_trial(params, shards, num_valid, trr, mode, fixed_intrinsics, cg_max_iter):
    """One trial step at trust radius `trr` (a tensor of the parameters'
    dtype): build and solve the damped system, apply the update.
    Returns (updated params, their MSE, predicted decrease, CG iterations)."""
    intr, trans, rot, points = params
    per, B, Cb, v, w = build_system_sharded(params, shards, mode, fixed_intrinsics)
    if mode == 3:
        dc, dp, pred, cg = solve_schur_sharded(per, shards, B, Cb, v, w, trr,
                                               cg_max_iter=cg_max_iter)
    elif mode == 1:
        dc, pred, cg = solve_cameras_only(B, v, trr, cg_max_iter=cg_max_iter)
        dp = torch.zeros_like(points)
    else:
        dp, pred = solve_points_only(Cb, w, trr)
        dc = torch.zeros((intr.shape[0], 9), dtype=intr.dtype, device=intr.device)
        cg = torch.zeros((), dtype=torch.int32, device=intr.device)
    del per
    new = apply_update(intr, trans, rot, points, dc, dp, fixed_intrinsics=fixed_intrinsics)
    return new, mse_sharded(new, shards, num_valid), pred, cg


def lm_optimize_sharded(intr, trans, rot, points, shards: ObservationShards, num_valid,
                        mode: int = 3, fixed_intrinsics: bool = False,
                        max_iters: int = 50, cg_max_iter: int = 1000,
                        lm_delta_threshold: float = 1e-4, lm_mse_threshold: float = 1e-8,
                        min_iters: int = 0, report=None):
    """The LM trust-region loop: trust region 1000 at the start, halved
    on a failed step, grown by the gain-ratio rule on success; stops on
    the delta-MSE ratio, the MSE threshold or max_iters. The parameters
    and num_valid are replicated (on one device); the observations are
    in `shards`.

    Every update is a tensor op as in mve_tpu's while_loop body (a failed
    step keeps the parameters through torch.where); the host reads the
    stop flag once per step. Returns (intr, trans, rot, points, status)
    with status = [initial_mse, final_mse, lm_iters, lm_success, lm_fail,
    cg_iters] as a tensor of intr's dtype.

    report: a callable taking one line of text. When given, the loop is
    mve_tpu's verbose BundleAdjustment loop instead (_lm_host_loop, the
    same trial step), which reads min_iters. Without it min_iters is not
    read: mve_tpu's device loop ignores lm_min_iterations.
    """
    def trial(params, trr):
        return _lm_trial(params, shards, num_valid, trr, mode, fixed_intrinsics, cg_max_iter)

    params = (intr, trans, rot, points)
    mse0 = mse_sharded(params, shards, num_valid)
    if report is not None:
        return _lm_host_loop(params, mse0, trial, float(num_valid), max_iters, min_iters,
                             lm_delta_threshold, lm_mse_threshold, report)
    dtype, dev = intr.dtype, intr.device
    trr = torch.tensor(1000.0, dtype=dtype, device=dev)
    mse = mse0
    done = mse0 < lm_mse_threshold
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_ok, n_fail, n_cg = zero, zero, zero
    it = 0
    while it < max_iters and not bool(done):
        new, new_mse, pred, cg = trial(params, trr)
        delta_mse = mse - new_mse
        success = delta_mse > 0.0

        gain = delta_mse * num_valid / torch.where(pred == 0.0, 1.0, pred)
        tr_up = 1.0 / torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
        trr = torch.where(success, trr * tr_up, trr * 0.5)

        params = tuple(torch.where(success, n, o) for n, o in zip(new, params))
        delta_ratio = 1.0 - new_mse / torch.clamp(mse, min=1e-300)
        mse = torch.where(success, new_mse, mse)
        done = (success & (delta_ratio < lm_delta_threshold)) | (mse < lm_mse_threshold)
        n_ok = n_ok + success.to(torch.int32)
        n_fail = n_fail + (~success).to(torch.int32)
        n_cg = n_cg + cg
        it += 1
    status = torch.stack([mse0, mse, torch.tensor(float(it), dtype=dtype, device=dev),
                          n_ok.to(dtype), n_fail.to(dtype), n_cg.to(dtype)])
    return (*params, status)


def _lm_host_loop(params, mse0, trial, n_obs, max_iters, min_iters,
                  lm_delta_threshold, lm_mse_threshold, report):
    """mve_tpu's verbose BundleAdjustment loop (mve_tpu/sfm/ba/lm.py:266-347)
    around lm_optimize_sharded's trial step: the trust region, the gain
    ratio and the MSE tests are host float64, each step reports a line
    and the stop reports why, and the stop tests are skipped until
    min_iters steps have run (the MSE test before a step, the
    delta-ratio and max_iters tests after it)."""
    dtype, dev = params[0].dtype, params[0].device
    trr, mse = 1000.0, float(mse0)
    it = n_ok = n_fail = n_cg = 0
    while True:
        if it + 1 > min_iters and mse < lm_mse_threshold:
            report("BA: Satisfied MSE threshold.")
            break
        new, new_mse, pred, cg = trial(params, torch.tensor(trr, dtype=dtype, device=dev))
        new_mse, cg = float(new_mse), int(cg)
        delta_mse = mse - new_mse
        delta_ratio = 1.0 - new_mse / max(mse, 1e-300)
        n_cg += cg
        success = delta_mse > 0.0
        if success:
            report(f"BA: #{it:2d} success, MSE {mse:.6e} -> {new_mse:.6e}, "
                   f"CG {cg:3d}, TRR {trr:g}")
            n_ok += 1
            params, mse = new, new_mse
            pred = float(pred)
            gain = delta_mse * n_obs / pred if pred != 0.0 else 1.0
            trr *= 1.0 / max(1.0 / 3.0, 1.0 - (2.0 * gain - 1.0) ** 3)
        else:
            report(f"BA: #{it:2d} failure, MSE {mse:.6e}, CG {cg:3d}, TRR {trr:g}")
            n_fail += 1
            trr *= 0.5
        it += 1
        if it < min_iters:
            continue
        if it >= max_iters:
            report(f"BA: Reached maximum LM iterations of {max_iters}")
            break
        if success and delta_ratio < lm_delta_threshold:
            report(f"BA: Satisfied delta mse ratio threshold of {lm_delta_threshold}")
            break
    status = torch.tensor([float(mse0), mse, it, n_ok, n_fail, n_cg], dtype=dtype, device=dev)
    return (*params, status)
