"""Degenerate-triangle cleanup (reference: libs/fssr/mesh_clean.h:23-37,
mesh_clean.cc; port of mve_tpu/fssr/mesh_clean.py, host numpy, with
mve_tpu's pure-Python union-find in place of its native binding).

clean_needles collapses edges shorter than needle_ratio x the longest
incident edge; clean_caps collapses vertices whose incident triangles are
nearly flat caps; clean_mc_mesh runs both the way fssrecon/meshclean do.
"""

from __future__ import annotations

import numpy as np

from ..core.mesh import TriangleMesh


def _collapse_edges(mesh: TriangleMesh, edges: np.ndarray) -> int:
    """Collapse vertex b into a for each (a, b) edge; returns collapses."""
    if len(edges) == 0:
        return 0
    n = mesh.num_vertices()
    # Union-find, in the order and with the skip rule and float32
    # midpoints of native/mve_native.cpp's mesh_collapse_edges.
    target = np.arange(n)

    def find(x):
        while target[x] != x:
            target[x] = target[target[x]]
            x = target[x]
        return x

    touched = np.zeros(n, bool)
    count = 0
    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra == rb or touched[ra] or touched[rb]:
            continue
        target[rb] = ra
        mesh.vertices[ra] = 0.5 * (mesh.vertices[ra] + mesh.vertices[rb])
        touched[ra] = True
        count += 1
    if count == 0:
        return 0
    target = np.array([find(i) for i in range(n)])
    mesh.faces = target[mesh.faces].astype(np.int32)
    ok = ((mesh.faces[:, 0] != mesh.faces[:, 1])
          & (mesh.faces[:, 1] != mesh.faces[:, 2])
          & (mesh.faces[:, 0] != mesh.faces[:, 2]))
    mesh.faces = mesh.faces[ok]
    mesh.delete_unreferenced_vertices()
    return count


def clean_needles(mesh: TriangleMesh, needle_ratio: float = 0.4) -> int:
    """Collapse needle edges: shortest edge < ratio x longest edge of the
    same face (mesh_clean.cc clean_needles)."""
    if mesh.num_faces() == 0:
        return 0
    v = mesh.vertices
    f = mesh.faces
    e = np.stack([
        np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=1),
        np.linalg.norm(v[f[:, 1]] - v[f[:, 2]], axis=1),
        np.linalg.norm(v[f[:, 2]] - v[f[:, 0]], axis=1),
    ], axis=1)
    shortest = e.argmin(axis=1)
    is_needle = e.min(axis=1) < needle_ratio * e.max(axis=1)
    rows = np.nonzero(is_needle)[0]
    pairs = []
    edge_corners = [(0, 1), (1, 2), (2, 0)]
    for r in rows:
        a, b = edge_corners[shortest[r]]
        pairs.append((f[r, a], f[r, b]))
    return _collapse_edges(mesh, np.array(pairs, np.int64).reshape(-1, 2))


def clean_caps(mesh: TriangleMesh, cap_angle_cos: float = -0.98) -> int:
    """Remove cap triangles: one interior angle near 180 degrees — the
    apex vertex is collapsed onto the midpoint of the long edge
    (mesh_clean.cc clean_caps)."""
    if mesh.num_faces() == 0:
        return 0
    v = mesh.vertices
    f = mesh.faces
    count = 0
    pairs = []
    for c, (a, b) in enumerate([(1, 2), (2, 0), (0, 1)]):
        e1 = v[f[:, a]] - v[f[:, c]]
        e2 = v[f[:, b]] - v[f[:, c]]
        cosang = np.sum(e1 * e2, axis=1) / np.maximum(
            np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-30)
        caps = np.nonzero(cosang < cap_angle_cos)[0]
        for r in caps:
            pairs.append((f[r, a], f[r, c]))
    return _collapse_edges(mesh, np.array(pairs, np.int64).reshape(-1, 2))


def clean_mc_mesh(mesh: TriangleMesh, needle_iterations: int = 2) -> int:
    """Needles + caps passes (mesh_clean.h clean_mc_mesh)."""
    total = 0
    for _ in range(needle_iterations):
        n = clean_needles(mesh)
        n += clean_caps(mesh)
        total += n
        if n == 0:
            break
    return total
