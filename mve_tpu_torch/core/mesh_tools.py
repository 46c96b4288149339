"""Mesh utilities: transforms, merging, components
(reference: libs/mve/mesh_tools.cc).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .mesh import TriangleMesh


def mesh_transform(mesh: TriangleMesh, matrix: np.ndarray) -> None:
    """Apply a 4x4 transform in place; normals by the rotation part."""
    M = np.asarray(matrix, np.float64)
    if mesh.num_vertices():
        v = mesh.vertices @ M[:3, :3].T + M[:3, 3]
        mesh.vertices = v.astype(np.float32)
    if mesh.has_vertex_normals():
        n = mesh.vertex_normals @ M[:3, :3].T
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        mesh.vertex_normals = (n / np.maximum(norm, 1e-30)).astype(np.float32)


def mesh_merge(meshes: List[TriangleMesh]) -> TriangleMesh:
    """Concatenate meshes, offsetting face indices."""
    out = TriangleMesh()
    verts, faces, colors, confs, values, normals = [], [], [], [], [], []
    offset = 0
    any_colors = any(m.has_vertex_colors() for m in meshes)
    any_confs = any(m.has_vertex_confidences() for m in meshes)
    any_values = any(m.has_vertex_values() for m in meshes)
    any_normals = any(m.has_vertex_normals() for m in meshes)
    for m in meshes:
        n = m.num_vertices()
        if n == 0:
            continue
        verts.append(m.vertices)
        if m.num_faces():
            faces.append(m.faces + offset)
        if any_colors:
            colors.append(m.vertex_colors if m.has_vertex_colors()
                          else np.ones((n, 4), np.float32))
        if any_confs:
            confs.append(m.vertex_confidences if m.has_vertex_confidences()
                         else np.ones(n, np.float32))
        if any_values:
            values.append(m.vertex_values if m.has_vertex_values()
                          else np.zeros(n, np.float32))
        if any_normals:
            normals.append(m.vertex_normals if m.has_vertex_normals()
                           else np.zeros((n, 3), np.float32))
        offset += n
    if verts:
        out.vertices = np.concatenate(verts)
        out.faces = np.concatenate(faces) if faces else np.zeros((0, 3), np.int32)
        if any_colors:
            out.vertex_colors = np.concatenate(colors)
        if any_confs:
            out.vertex_confidences = np.concatenate(confs)
        if any_values:
            out.vertex_values = np.concatenate(values)
        if any_normals:
            out.vertex_normals = np.concatenate(normals)
    return out


def mesh_components(mesh: TriangleMesh) -> np.ndarray:
    """Connected-component label per vertex (via union-find over edges):
    the native library's where built, else the same union-find in Python."""
    n = mesh.num_vertices()
    from .. import native as _native

    labels = _native.components(n, mesh.faces)
    if labels is not None:
        return labels
    parent = np.arange(n)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in mesh.faces:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        ra, rb, rc = find(a), find(b), find(c)
        parent[rb] = ra
        parent[find(rc)] = find(ra)
    return np.array([find(i) for i in range(n)])


def mesh_delete_small_components(mesh: TriangleMesh, min_vertices: int) -> int:
    """Remove components smaller than min_vertices (meshclean behavior).
    Returns number of deleted vertices."""
    if mesh.num_vertices() == 0 or min_vertices <= 0:
        return 0
    labels = mesh_components(mesh)
    counts = np.bincount(labels, minlength=mesh.num_vertices())
    delete = counts[labels] < min_vertices
    n_deleted = int(delete.sum())
    if n_deleted:
        mesh.delete_vertices_fix_faces(delete)
    return n_deleted
