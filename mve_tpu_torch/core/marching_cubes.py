"""Table-driven Marching Cubes (reference: libs/mve/marching_cubes.h; a
copy of mve_tpu/core/marching_cubes.py, host numpy).

Unlike the reference, which ships hard-coded 256-entry lookup tables, the
tables here are *derived at import time* from first principles: for every
sign configuration, marching-squares contours are built on each cube face
(with the ambiguous diagonal case resolved by always separating the inside
corners — the same orientation-independent rule from both sides of a face,
so adjacent cubes always agree and the extracted surface is crack-free),
chained into closed polygons, and fan-triangulated. The construction is
validated by assertions (every cut edge chains exactly once) and by the
watertightness tests in tests/test_marching_cubes.py.

Runtime extraction is fully vectorized over the active cubes: one pass
classifies all cubes, gathers triangles from the table, deduplicates
iso-vertices via global edge keys, and interpolates positions — no
per-cube Python loop (the reference iterates cube-by-cube through an
accessor; marching_cubes.h:85-160).

Corner numbering: corner ``i`` sits at offset ``(i&1, (i>>1)&1, (i>>2)&1)``
in (x, y, z). Edge numbering: edge ``a*4 + r`` is the edge along axis ``a``
from the ``r``-th corner (ascending id) whose bit ``a`` is zero.
"""

from __future__ import annotations

import numpy as np

from .mesh import TriangleMesh

# --------------------------------------------------------------------------
# table construction
# --------------------------------------------------------------------------

_CORNER_OFFSETS = np.array([[(i >> a) & 1 for a in range(3)]
                            for i in range(8)], np.int64)

# edge index -> (corner_a, corner_b, axis); edge a*4+r runs along axis a.
_EDGES = []
for _a in range(3):
    for _c in [c for c in range(8) if not (c >> _a) & 1]:
        _EDGES.append((_c, _c | (1 << _a), _a))
_EDGE_INDEX = {(a, b): i for i, (a, b, _) in enumerate(_EDGES)}
_EDGE_INDEX.update({(b, a): i for i, (a, b, _) in enumerate(_EDGES)})


def _face_corners():
    """Corner cycles of the 6 cube faces, CCW viewed from outside."""
    faces = []
    for axis in range(3):
        u, v = (axis + 1) % 3, (axis + 2) % 3  # u x v == +axis
        for side in (0, 1):
            cyc = []
            for bu, bv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                cyc.append((side << axis) | (bu << u) | (bv << v))
            if side == 0:  # outward normal is -axis: reverse the cycle
                cyc.reverse()
            faces.append(cyc)
    return faces


_FACES = _face_corners()


def _config_segments(config: int):
    """Directed iso-contour segments (from_edge -> to_edge) of one cube
    configuration, one marching-squares pass per face. Segments are
    directed so the inside (sdf < 0) region lies left of the contour when
    viewed from outside the cube."""
    segments = []
    for f in _FACES:
        inside = [(config >> c) & 1 for c in f]
        if sum(inside) in (0, 4):
            continue
        # Maximal cyclic runs of inside corners: each contributes one
        # segment from the run's exit cut to its entry cut.
        for j in range(4):
            if not (inside[j] and not inside[j - 1]):
                continue  # j is not the start of a run
            k = j
            while inside[(k + 1) % 4]:
                k = (k + 1) % 4
            entry = _EDGE_INDEX[(f[j - 1], f[j])]
            exit_ = _EDGE_INDEX[(f[k], f[(k + 1) % 4])]
            segments.append((exit_, entry))
    return segments


def _build_tables():
    tri_lists = []
    for config in range(256):
        nxt = {}
        for a, b in _config_segments(config):
            assert a not in nxt, f"config {config}: edge {a} chains twice"
            nxt[a] = b
        tris = []
        seen = set()
        for start in list(nxt):
            if start in seen:
                continue
            cycle = [start]
            seen.add(start)
            cur = nxt[start]
            while cur != start:
                cycle.append(cur)
                seen.add(cur)
                cur = nxt[cur]
            assert len(cycle) >= 3, f"config {config}: degenerate cycle"
            # Reversed fan: contour cycles chain with inside-left seen from
            # outside; reversing gives outward-pointing triangle normals
            # (toward increasing SDF), matching marching_tets.
            for i in range(1, len(cycle) - 1):
                tris.append((cycle[0], cycle[i + 1], cycle[i]))
        tri_lists.append(tris)

    maxt = max(len(t) for t in tri_lists)
    table = np.full((256, maxt, 3), -1, np.int32)
    counts = np.zeros(256, np.int32)
    for c, tris in enumerate(tri_lists):
        counts[c] = len(tris)
        for i, t in enumerate(tris):
            table[c, i] = t
    return table, counts


MC_TRI_TABLE, MC_TRI_COUNTS = _build_tables()

# 12-bit cut-edge mask per configuration (mc_edge_table equivalent).
MC_EDGE_TABLE = np.zeros(256, np.int32)
for _c in range(256):
    for _t in MC_TRI_TABLE[_c][: MC_TRI_COUNTS[_c]]:
        for _e in _t:
            MC_EDGE_TABLE[_c] |= 1 << int(_e)

# Per local edge: offset of the lower grid endpoint and the edge axis.
_EDGE_LOWER = np.array([_CORNER_OFFSETS[a] for (a, b, _) in _EDGES], np.int64)
_EDGE_AXIS = np.array([ax for (_, _, ax) in _EDGES], np.int64)


# --------------------------------------------------------------------------
# vectorized extraction over a dense volume
# --------------------------------------------------------------------------

def marching_cubes(volume, iso: float = 0.0) -> TriangleMesh:
    """Polygonize the iso-surface of a dense Volume with Marching Cubes.

    Drop-in alternative to marching_tets (fewer, better-shaped triangles:
    no diagonal tet edges). Faces are wound so normals point toward
    increasing values (outside), matching marching_tets.
    """
    vals = np.asarray(volume.data, np.float32) - np.float32(iso)
    Z, Y, X = vals.shape
    if X < 2 or Y < 2 or Z < 2:
        return TriangleMesh()

    inside = vals < 0
    config = np.zeros((Z - 1, Y - 1, X - 1), np.uint8)
    for i, (dx, dy, dz) in enumerate(_CORNER_OFFSETS):
        config |= (inside[dz:dz + Z - 1, dy:dy + Y - 1, dx:dx + X - 1]
                   << np.uint8(i))
    active = np.nonzero((config != 0) & (config != 255))
    if len(active[0]) == 0:
        return TriangleMesh()
    acfg = config[active]
    cz, cy, cx = (a.astype(np.int64) for a in active)

    # Gather per-cube triangles (local edge ids), then mask the padding.
    tris = MC_TRI_TABLE[acfg]                      # (N, MAXT, 3)
    valid = tris[:, :, 0] >= 0                     # (N, MAXT)
    ncubes, maxt, _ = tris.shape
    tri_cube = np.broadcast_to(np.arange(ncubes)[:, None], (ncubes, maxt))
    tri_cube = tri_cube[valid]                     # (T,)
    tri_edges = tris[valid]                        # (T, 3) local edge ids

    # Global edge key: lower endpoint's flat grid id * 3 + axis.
    lower = _EDGE_LOWER[tri_edges]                 # (T, 3, 3) xyz offsets
    gx = cx[tri_cube][:, None] + lower[:, :, 0]
    gy = cy[tri_cube][:, None] + lower[:, :, 1]
    gz = cz[tri_cube][:, None] + lower[:, :, 2]
    keys = ((gz * Y + gy) * X + gx) * 3 + _EDGE_AXIS[tri_edges]

    uniq, faces = np.unique(keys, return_inverse=True)
    faces = faces.reshape(-1, 3).astype(np.int32)

    # Interpolate one iso-vertex per unique cut edge.
    axis = (uniq % 3).astype(np.int64)
    pid = uniq // 3
    ix = pid % X
    iy = (pid // X) % Y
    iz = pid // (X * Y)
    jx = ix + (axis == 0)
    jy = iy + (axis == 1)
    jz = iz + (axis == 2)
    va = vals[iz, iy, ix].astype(np.float64)
    vb = vals[jz, jy, jx].astype(np.float64)
    denom = va - vb
    denom = np.where(np.abs(denom) < 1e-30, 1e-30, denom)
    t = np.clip(va / denom, 0.0, 1.0)
    pa = volume.voxel_positions(ix, iy, iz)
    pb = volume.voxel_positions(jx, jy, jz)

    mesh = TriangleMesh()
    mesh.vertices = (pa + (pb - pa) * t[:, None]).astype(np.float32)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    mesh.faces = faces[ok]
    mesh.delete_unreferenced_vertices()
    return mesh


class CubeAccessor:
    """Reference-style accessor contract (marching_cubes.h:26-41): repeated
    next() calls yield cubes with ``sdf[8]`` values, unique ``vid[8]``
    corner ids, and ``pos[8]`` corner positions — corner numbering as
    documented in this module. Used by marching_cubes_accessor for sparse /
    non-grid SDF representations (e.g. octrees)."""

    def next(self) -> bool:  # pragma: no cover - interface only
        raise NotImplementedError

    sdf: np.ndarray
    vid: np.ndarray
    pos: np.ndarray


def marching_cubes_accessor(accessor) -> TriangleMesh:
    """Accessor-driven Marching Cubes for non-dense SDF partitions."""
    verts = []
    faces = []
    vert_ids = {}
    while accessor.next():
        cfg = 0
        for i in range(8):
            if accessor.sdf[i] < 0.0:
                cfg |= 1 << i
        if cfg in (0, 255):
            continue
        for tri in MC_TRI_TABLE[cfg][: MC_TRI_COUNTS[cfg]]:
            ids = []
            for e in tri:
                a, b, _ = _EDGES[e]
                key = (min(accessor.vid[a], accessor.vid[b]),
                       max(accessor.vid[a], accessor.vid[b]))
                vi = vert_ids.get(key)
                if vi is None:
                    da, db = float(accessor.sdf[a]), float(accessor.sdf[b])
                    denom = da - db
                    if abs(denom) < 1e-30:
                        denom = 1e-30
                    t = min(max(da / denom, 0.0), 1.0)
                    p = (np.asarray(accessor.pos[a], np.float64) * (1 - t)
                         + np.asarray(accessor.pos[b], np.float64) * t)
                    vi = len(verts)
                    verts.append(p)
                    vert_ids[key] = vi
                ids.append(vi)
            if ids[0] != ids[1] and ids[1] != ids[2] and ids[0] != ids[2]:
                faces.append(ids)
    mesh = TriangleMesh()
    if verts:
        mesh.vertices = np.asarray(verts, np.float32)
    if faces:
        mesh.faces = np.asarray(faces, np.int32)
    return mesh
