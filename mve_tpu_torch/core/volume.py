"""Regular voxel volume + polygonization (reference: libs/mve/volume.h,
marching_cubes.h, marching_tets.h, marching.cc; a copy of
mve_tpu/core/volume.py, host numpy).

Volume stores a dense (Z, Y, X) scalar grid with optional per-voxel
color/confidence. Polygonization uses the 6-tetrahedra cube decomposition
(the reference ships both accessor-templated marching cubes and marching
tets; the tet variant is topology-equivalent and crack-free on uniform
grids). Iso-vertices on shared edges are deduplicated so the output is
watertight.
"""

from __future__ import annotations

import numpy as np

from .mesh import TriangleMesh

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


class Volume:
    """Dense scalar volume over the unit cube (volume.h:28-70)."""

    def __init__(self, data: np.ndarray,
                 origin=(0.0, 0.0, 0.0), size=(1.0, 1.0, 1.0)):
        self.data = np.asarray(data, np.float32)  # (Z, Y, X)
        self.origin = np.asarray(origin, np.float64)
        self.size = np.asarray(size, np.float64)

    @property
    def dims(self):
        return self.data.shape[::-1]  # (X, Y, Z)

    def voxel_positions(self, ix, iy, iz):
        d = np.array(self.data.shape[::-1], np.float64) - 1
        rel = np.stack([ix, iy, iz], axis=-1) / np.maximum(d, 1)
        return self.origin + rel * self.size


def marching_tets(volume: Volume, iso: float = 0.0) -> TriangleMesh:
    """Extract the iso-surface of a dense volume (marching.cc equivalent)."""
    vals = volume.data - iso
    Z, Y, X = vals.shape
    if X < 2 or Y < 2 or Z < 2:
        return TriangleMesh()

    # All cells, corner linear ids.
    czs, cys, cxs = np.mgrid[0 : Z - 1, 0 : Y - 1, 0 : X - 1]
    cells = np.stack([cxs.reshape(-1), cys.reshape(-1), czs.reshape(-1)], axis=1)
    stride_y, stride_z = X, X * Y
    corner_ids = (cells[:, None, 0] + _CORNER_OFFSETS[None, :, 0]
                  + (cells[:, None, 1] + _CORNER_OFFSETS[None, :, 1]) * stride_y
                  + (cells[:, None, 2] + _CORNER_OFFSETS[None, :, 2]) * stride_z)
    flat = vals.reshape(-1)
    cvals = flat[corner_ids]  # (C, 8)
    # Skip cells with no sign change.
    active = (cvals.min(axis=1) < 0) & (cvals.max(axis=1) >= 0)
    corner_ids = corner_ids[active]
    inside = flat[corner_ids] < 0

    tet_vox = corner_ids[:, _TETS].reshape(-1, 4)
    tet_in = inside[:, _TETS].reshape(-1, 4)
    mask = (tet_in[:, 0].astype(np.int8) | (tet_in[:, 1].astype(np.int8) << 1)
            | (tet_in[:, 2].astype(np.int8) << 2) | (tet_in[:, 3].astype(np.int8) << 3))

    from ..fssr.iso_surface import _tet_case_table

    table = _tet_case_table()
    tri_a, tri_b = [], []
    for m in range(1, 15):
        rows = np.nonzero(mask == m)[0]
        if len(rows) == 0:
            continue
        for tri in table[m]:
            ea = np.array([e[0] for e in tri])
            eb = np.array([e[1] for e in tri])
            tri_a.append(tet_vox[rows][:, ea])
            tri_b.append(tet_vox[rows][:, eb])
    if not tri_a:
        return TriangleMesh()
    A = np.concatenate(tri_a)
    B = np.concatenate(tri_b)
    lo = np.minimum(A, B)
    hi = np.maximum(A, B)
    keys = lo.astype(np.int64) * (X * Y * Z) + hi
    uniq, faces = np.unique(keys, return_inverse=True)
    faces = faces.reshape(-1, 3).astype(np.int32)
    ua = (uniq // (X * Y * Z)).astype(np.int64)
    ub = (uniq % (X * Y * Z)).astype(np.int64)

    def id_to_xyz(ids):
        iz = ids // stride_z
        rem = ids % stride_z
        iy = rem // stride_y
        ix = rem % stride_y
        return ix, iy, iz

    va = flat[ua]
    vb = flat[ub]
    t = va / np.where(np.abs(va - vb) < 1e-30, 1e-30, va - vb)
    t = np.clip(t, 0.0, 1.0)
    pa = volume.voxel_positions(*id_to_xyz(ua))
    pb = volume.voxel_positions(*id_to_xyz(ub))
    mesh = TriangleMesh()
    mesh.vertices = (pa + (pb - pa) * t[:, None]).astype(np.float32)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    mesh.faces = faces[ok]
    mesh.delete_unreferenced_vertices()
    # Orient faces by the volume gradient (outward = increasing value).
    if mesh.num_faces():
        gz, gy, gx = np.gradient(vals)
        c = ((mesh.vertices[mesh.faces[:, 0]] + mesh.vertices[mesh.faces[:, 1]]
              + mesh.vertices[mesh.faces[:, 2]]) / 3.0 - volume.origin) / volume.size
        d = np.array(vals.shape[::-1], np.float64) - 1
        ci = np.clip(np.round(c * d).astype(int), 0, [X - 1, Y - 1, Z - 1])
        grad = np.stack([gx[ci[:, 2], ci[:, 1], ci[:, 0]],
                         gy[ci[:, 2], ci[:, 1], ci[:, 0]],
                         gz[ci[:, 2], ci[:, 1], ci[:, 0]]], axis=1)
        v0 = mesh.vertices[mesh.faces[:, 0]]
        v1 = mesh.vertices[mesh.faces[:, 1]]
        v2 = mesh.vertices[mesh.faces[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        flip = np.sum(fn * grad, axis=1) < 0
        mesh.faces[flip] = mesh.faces[flip][:, [0, 2, 1]]
    return mesh


# Table-driven marching cubes (derived tables, vectorized extraction) lives
# in marching_cubes.py; re-exported here to mirror the reference's
# mve::geom namespace grouping.
from .marching_cubes import marching_cubes, marching_cubes_accessor  # noqa: E402,F401
