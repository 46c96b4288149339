"""Iso-surface extraction from the sparse voxel grid
(reference: libs/fssr/iso_surface.cc — here via marching tetrahedra on
the uniform sparse grid; the reference's cross-level adaptive MC is a
later-round upgrade; see libs/mve/marching_tets.h for the reference's
own MT variant). Port of mve_tpu/fssr/iso_surface.py, host numpy.

Each active cell splits into 6 tetrahedra around the 0-7 diagonal.
Iso-vertices are placed on sign-crossing edges by linear interpolation of
the implicit function (Hermite cubic via the stored derivative is
available with use_hermite=True, hermite.h:17-43); vertices are deduped
on shared edges so the surface is watertight across cells. Per-vertex
confidence, scale and color are interpolated alongside.
"""

from __future__ import annotations

import numpy as np

from ..core.mesh import TriangleMesh
from .iso_octree import VoxelGrid

# 6-tet decomposition of the cube around the 0-7 diagonal; corner ids use
# bits (x=1, y=2, z=4). Every tet lists (0, a, b, 7) with positive
# orientation.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int64)

_CORNER_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)


class IsoSurface:
    """Mirrors fssr::IsoSurface (iso_surface.h:38-126).

    interpolation: 'linear', 'scaling', 'lsderiv' or 'cubic' — the
    reference's iso-vertex root-finding variants (hermite.cc
    interpolate_root; the default build uses derivatives with CUBIC,
    defines.h:20, iso_surface.h:41)."""

    def __init__(self, grid: VoxelGrid, use_hermite: bool | None = None,
                 interpolation: str = "cubic"):
        self.grid = grid
        if use_hermite is not None:  # legacy bool: True -> cubic
            interpolation = "cubic" if use_hermite else "linear"
        if interpolation not in ("linear", "scaling", "lsderiv", "cubic"):
            raise ValueError(f"invalid interpolation: {interpolation}")
        self.interpolation = interpolation
        self.use_hermite = interpolation != "linear"

    def extract_mesh(self) -> TriangleMesh:
        g = self.grid
        dims = g.dims
        stride_y = dims[0]
        stride_z = dims[0] * dims[1]

        # Dense lookup from voxel code -> index into voxel arrays.
        code_sorted = g.voxel_codes  # already unique + sorted
        def lookup(codes):
            idx = np.searchsorted(code_sorted, codes)
            idx = np.clip(idx, 0, len(code_sorted) - 1)
            ok = code_sorted[idx] == codes
            return idx, ok

        cells = g.active_cells  # (C, 3)
        corner_codes = ((cells[:, None, 0] + _CORNER_OFFSETS[None, :, 0])
                        + (cells[:, None, 1] + _CORNER_OFFSETS[None, :, 1]) * stride_y
                        + (cells[:, None, 2] + _CORNER_OFFSETS[None, :, 2]) * stride_z)
        cidx, cok = lookup(corner_codes.reshape(-1))
        cidx = cidx.reshape(-1, 8)
        cok = cok.reshape(-1, 8)
        conf_ok = (g.conf[cidx] > 0).all(axis=1) & cok.all(axis=1)
        cells_ok = np.nonzero(conf_ok)[0]
        if len(cells_ok) == 0:
            return TriangleMesh()
        cidx = cidx[cells_ok]  # (C', 8) voxel indices per cell

        vals = g.value[cidx]  # (C', 8)
        inside = vals < 0.0

        # Expand to tets: (C', 6, 4) voxel indices and inside flags.
        tet_vox = cidx[:, _TETS]          # (C', 6, 4)
        tet_in = inside[:, _TETS]         # (C', 6, 4)
        mask = (tet_in[..., 0].astype(np.int8)
                | (tet_in[..., 1].astype(np.int8) << 1)
                | (tet_in[..., 2].astype(np.int8) << 2)
                | (tet_in[..., 3].astype(np.int8) << 3))
        tet_vox = tet_vox.reshape(-1, 4)
        mask = mask.reshape(-1)

        # Marching-tets case table: for each of the 16 masks, triangles as
        # (corner_a, corner_b) edge pairs. Winding chosen so triangle
        # normals point toward the POSITIVE side of the function (outside,
        # matching FSSR's in-front-positive convention).
        #
        # Single-corner cases: corner i inside -> triangle over edges
        # (i,a),(i,b),(i,c) where (a,b,c) is the opposite face ordered to
        # give outward winding. Two-corner cases produce quads.
        edge_tris = _tet_case_table()

        tri_edge_a = []
        tri_edge_b = []
        for m in range(1, 15):
            tris = edge_tris[m]
            if not tris:
                continue
            rows = np.nonzero(mask == m)[0]
            if len(rows) == 0:
                continue
            for tri in tris:
                ea = np.array([e[0] for e in tri])
                eb = np.array([e[1] for e in tri])
                tri_edge_a.append(tet_vox[rows][:, ea])
                tri_edge_b.append(tet_vox[rows][:, eb])
        if not tri_edge_a:
            return TriangleMesh()
        A = np.concatenate(tri_edge_a)  # (T, 3) voxel index of inside end
        B = np.concatenate(tri_edge_b)  # (T, 3) voxel index of outside end

        # Deduplicate iso-vertices on edges keyed by (min, max) voxel idx.
        lo = np.minimum(A, B)
        hi = np.maximum(A, B)
        keys = lo.astype(np.int64) * len(code_sorted) + hi
        uniq, faces = np.unique(keys, return_inverse=True)
        faces = faces.reshape(-1, 3).astype(np.int32)
        ua = (uniq // len(code_sorted)).astype(np.int64)
        ub = (uniq % len(code_sorted)).astype(np.int64)

        # Interpolate along each edge: find t with value(t) = 0.
        va = g.value[ua]
        vb = g.value[ub]
        pa = g.voxel_position(code_sorted[ua])
        pb = g.voxel_position(code_sorted[ub])
        denom = va - vb
        t = va / np.where(np.abs(denom) < 1e-30, 1e-30, denom)
        if self.interpolation == "cubic":
            t = self._hermite_roots(va, vb, g.deriv[ua], g.deriv[ub], pb - pa, t)
        elif self.interpolation in ("scaling", "lsderiv"):
            t = self._quadratic_roots(va, vb, g.deriv[ua], g.deriv[ub],
                                      pb - pa, t, self.interpolation)
        t = np.clip(t, 0.0, 1.0)
        verts = pa + (pb - pa) * t[:, None]

        mesh = TriangleMesh()
        mesh.vertices = verts.astype(np.float32)
        mesh.faces = faces
        tcol = g.color[ua] + (g.color[ub] - g.color[ua]) * t[:, None]
        mesh.vertex_colors = np.concatenate(
            [np.clip(tcol, 0, 1), np.ones((len(verts), 1))], axis=1).astype(np.float32)
        mesh.vertex_confidences = (
            g.conf[ua] + (g.conf[ub] - g.conf[ua]) * t).astype(np.float32)
        mesh.vertex_values = (
            g.scale[ua] + (g.scale[ub] - g.scale[ua]) * t).astype(np.float32)

        # Drop degenerate faces (dedup can collapse edges).
        f = mesh.faces
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        mesh.faces = f[ok]
        mesh.delete_unreferenced_vertices()
        self._orient_faces(mesh)
        return mesh

    # ------------------------------------------------------------------
    @staticmethod
    def _quadratic_roots(va, vb, da, db, edge_vec, t_lin, kind: str):
        """The reference's SCALING / LSDERIV quadratic iso-vertex
        interpolants (hermite.cc interpolate_root:159-175), vectorized.
        Falls back to the linear t where no root lies in [0, 1]."""
        d0 = np.sum(da * edge_vec, axis=1)
        d1 = np.sum(db * edge_vec, axis=1)
        if kind == "scaling":
            denom = d0 + d1
            scale = 2.0 * (vb - va) / np.where(np.abs(denom) < 1e-30,
                                               1e-30, denom)
            a0 = va
            a1 = d0 * scale
            a2 = 3.0 * (vb - va) - (2.0 * d0 + d1) * scale
        else:  # lsderiv
            a0 = va
            a1 = (d0 - d1) / 2.0 + vb - va
            a2 = (d1 - d0) / 2.0
        # Roots of a0 + a1 t + a2 t^2.
        with np.errstate(invalid="ignore", divide="ignore"):
            disc = a1 * a1 - 4.0 * a2 * a0
            sq = np.sqrt(np.maximum(disc, 0.0))
            a2s = np.where(np.abs(a2) < 1e-30, 1e-30, a2)
            r1 = (-a1 + sq) / (2.0 * a2s)
            r2 = (-a1 - sq) / (2.0 * a2s)
            lin = -a0 / np.where(np.abs(a1) < 1e-30, 1e-30, a1)
        ok1 = (disc >= 0) & (r1 >= 0) & (r1 <= 1) & (np.abs(a2) >= 1e-30)
        ok2 = (disc >= 0) & (r2 >= 0) & (r2 <= 1) & (np.abs(a2) >= 1e-30)
        deg = (np.abs(a2) < 1e-30) & (lin >= 0) & (lin <= 1)
        t = np.where(ok1, r1, np.where(ok2, r2, np.where(deg, lin, t_lin)))
        return np.where(np.isfinite(t), t, t_lin)

    # ------------------------------------------------------------------
    @staticmethod
    def _hermite_roots(va, vb, da, db, edge_vec, t_lin):
        """Cubic Hermite root on each edge (hermite.h:29-43); falls back
        to the linear t where the cubic has no root in [0, 1]."""
        ga = np.sum(da * edge_vec, axis=1)
        gb = np.sum(db * edge_vec, axis=1)
        # Cubic h(t) = h00 va + h10 ga + h01 vb + h11 gb; Newton from t_lin.
        t = t_lin.copy()
        for _ in range(8):
            t2 = t * t
            t3 = t2 * t
            h = ((2 * t3 - 3 * t2 + 1) * va + (t3 - 2 * t2 + t) * ga
                 + (-2 * t3 + 3 * t2) * vb + (t3 - t2) * gb)
            dh = ((6 * t2 - 6 * t) * va + (3 * t2 - 4 * t + 1) * ga
                  + (-6 * t2 + 6 * t) * vb + (3 * t2 - 2 * t) * gb)
            step = h / np.where(np.abs(dh) < 1e-20, 1e-20, dh)
            t = t - np.clip(step, -0.25, 0.25)
        bad = ~np.isfinite(t) | (t < 0) | (t > 1)
        return np.where(bad, t_lin, t)

    def _orient_faces(self, mesh: TriangleMesh) -> None:
        """Flip faces whose normal disagrees with the interpolated
        implicit-function gradient (positive side = outside)."""
        if mesh.num_faces() == 0:
            return
        g = self.grid
        v0 = mesh.vertices[mesh.faces[:, 0]]
        v1 = mesh.vertices[mesh.faces[:, 1]]
        v2 = mesh.vertices[mesh.faces[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        centers = (v0 + v1 + v2) / 3.0
        # Nearest voxel's derivative as the local gradient direction.
        rel = (centers - g.origin[None, :]) / g.cell_size
        c = np.round(rel).astype(np.int64)
        c = np.clip(c, 0, g.dims[None, :] - 1)
        codes = c[:, 0] + c[:, 1] * g.dims[0] + c[:, 2] * g.dims[0] * g.dims[1]
        idx = np.searchsorted(g.voxel_codes, codes)
        idx = np.clip(idx, 0, len(g.voxel_codes) - 1)
        grad = g.deriv[idx]
        flip = np.sum(fn * grad, axis=1) < 0
        mesh.faces[flip] = mesh.faces[flip][:, [0, 2, 1]]


def _tet_case_table():
    """Triangle lists per inside-mask for a tet (corners 0..3).

    Each triangle is three (inside_corner, outside_corner) edges. Winding
    is fixed afterwards by _orient_faces, so the table only needs correct
    topology.
    """
    table = {m: [] for m in range(16)}
    for m in range(1, 15):
        inside = [i for i in range(4) if m & (1 << i)]
        outside = [i for i in range(4) if not (m & (1 << i))]
        if len(inside) == 1:
            i = inside[0]
            a, b, c = outside
            table[m] = [[(i, a), (i, b), (i, c)]]
        elif len(inside) == 3:
            o = outside[0]
            a, b, c = inside
            table[m] = [[(a, o), (b, o), (c, o)]]
        else:  # two inside, two outside -> quad
            i0, i1 = inside
            o0, o1 = outside
            # Quad vertices: (i0,o0), (i0,o1), (i1,o1), (i1,o0)
            table[m] = [
                [(i0, o0), (i0, o1), (i1, o1)],
                [(i0, o0), (i1, o1), (i1, o0)],
            ]
    return table
