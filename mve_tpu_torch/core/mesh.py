"""Triangle mesh (reference: libs/mve/mesh.h, mesh_info.h).

Struct-of-arrays numpy storage: vertices (N,3) f32, faces (M,3) i32 and
optional per-vertex attributes — colors (N,4), confidences (N,), values
(N,), normals (N,3), texcoords (N,2) — matching the reference's attribute
set (mesh.h:29-126). All algorithms are vectorized.
"""

from __future__ import annotations

import numpy as np


class TriangleMesh:
    def __init__(self):
        self.vertices = np.zeros((0, 3), np.float32)
        self.faces = np.zeros((0, 3), np.int32)
        self.vertex_colors = np.zeros((0, 4), np.float32)
        self.vertex_confidences = np.zeros((0,), np.float32)
        self.vertex_values = np.zeros((0,), np.float32)
        self.vertex_normals = np.zeros((0, 3), np.float32)
        self.vertex_texcoords = np.zeros((0, 2), np.float32)
        self.face_normals = np.zeros((0, 3), np.float32)

    # -- attribute presence ------------------------------------------------
    def num_vertices(self) -> int:
        return len(self.vertices)

    def num_faces(self) -> int:
        return len(self.faces)

    def has_vertex_colors(self) -> bool:
        return len(self.vertex_colors) == len(self.vertices) > 0

    def has_vertex_confidences(self) -> bool:
        return len(self.vertex_confidences) == len(self.vertices) > 0

    def has_vertex_values(self) -> bool:
        return len(self.vertex_values) == len(self.vertices) > 0

    def has_vertex_normals(self) -> bool:
        return len(self.vertex_normals) == len(self.vertices) > 0

    def has_vertex_texcoords(self) -> bool:
        return len(self.vertex_texcoords) == len(self.vertices) > 0

    # -- normals (mesh.cc recalc_normals) ---------------------------------
    def recalc_normals(self, face_normals: bool = True, vertex_normals: bool = True) -> None:
        """Recompute face and angle-weighted vertex normals.

        The reference weights each face's contribution to a vertex normal
        by the face's interior angle at that vertex (mesh.cc:recalc_normals).
        """
        if self.num_faces() == 0:
            if face_normals:
                self.face_normals = np.zeros((0, 3), np.float32)
            if vertex_normals and self.num_vertices() > 0:
                self.vertex_normals = np.zeros((self.num_vertices(), 3), np.float32)
            return
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        norms = np.linalg.norm(fn, axis=1, keepdims=True)
        fn_unit = fn / np.maximum(norms, 1e-32)
        if face_normals:
            self.face_normals = fn_unit.astype(np.float32)
        if vertex_normals:
            nv = self.num_vertices()
            vn = np.zeros((nv, 3), np.float64)
            # Angle weights per corner; bincount is ~10x np.add.at for
            # the scatter-add (pset stage hot path, scene2pset.cc:264).
            for c, (a, b) in enumerate([(1, 2), (2, 0), (0, 1)]):
                pc = self.vertices[self.faces[:, c]]
                pa = self.vertices[self.faces[:, a]]
                pb = self.vertices[self.faces[:, b]]
                e1 = pa - pc
                e2 = pb - pc
                cosang = np.sum(e1 * e2, axis=1) / np.maximum(
                    np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-32
                )
                ang = np.arccos(np.clip(cosang, -1.0, 1.0))
                w = fn_unit * ang[:, None]
                idx = self.faces[:, c]
                for d in range(3):
                    vn[:, d] += np.bincount(idx, weights=w[:, d], minlength=nv)
            n = np.linalg.norm(vn, axis=1, keepdims=True)
            self.vertex_normals = (vn / np.maximum(n, 1e-32)).astype(np.float32)

    def ensure_normals(self) -> None:
        if not self.has_vertex_normals():
            self.recalc_normals()

    # -- topology edits (mesh.cc delete_vertices_fix_faces) ---------------
    def delete_vertices_fix_faces(self, delete_mask: np.ndarray) -> None:
        """Delete masked vertices, drop faces touching them, remap indices."""
        delete_mask = np.asarray(delete_mask, bool)
        keep = ~delete_mask
        remap = np.cumsum(keep) - 1
        if self.num_faces() > 0:
            face_ok = keep[self.faces].all(axis=1)
            self.faces = remap[self.faces[face_ok]].astype(np.int32)
        self.vertices = self.vertices[keep]
        for attr in ("vertex_colors", "vertex_confidences", "vertex_values", "vertex_normals", "vertex_texcoords"):
            arr = getattr(self, attr)
            if len(arr) == len(keep):
                setattr(self, attr, arr[keep])

    def delete_unreferenced_vertices(self) -> None:
        ref = np.zeros(self.num_vertices(), bool)
        if self.num_faces() > 0:
            ref[self.faces.reshape(-1)] = True
        self.delete_vertices_fix_faces(~ref)

    def get_aabb(self):
        if self.num_vertices() == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


class MeshInfo:
    """Vertex adjacency + classification (reference: libs/mve/mesh_info.h).

    Vertex classes: SIMPLE (closed disk fan), BORDER (open fan),
    COMPLEX (multiple fans / non-manifold), UNREFERENCED.
    """

    SIMPLE = 0
    COMPLEX = 1
    BORDER = 2
    UNREF = 3

    def __init__(self, mesh: TriangleMesh):
        self.mesh = mesh
        nv = mesh.num_vertices()
        faces = mesh.faces
        # vertex -> faces adjacency as CSR, built by sorting corner records.
        counts = np.bincount(faces.reshape(-1), minlength=nv).astype(np.int64)
        self.vf_off = np.zeros(nv + 1, np.int64)
        np.cumsum(counts, out=self.vf_off[1:])
        corner_v = faces.reshape(-1)
        corner_f = np.repeat(np.arange(len(faces), dtype=np.int64), 3)
        order = np.argsort(corner_v, kind="stable")
        self.vf = corner_f[order]
        self.vclass = self._classify()

    def faces_of_vertex(self, v: int) -> np.ndarray:
        return self.vf[self.vf_off[v] : self.vf_off[v + 1]]

    def _classify(self) -> np.ndarray:
        """Vertex classes of mesh_info.cc, for all vertices at once.

        Each face incident to v contributes its edge (a, b) opposite v, in
        winding order. With no start a repeated, the edges form the link
        of v as a graph where every node has at most one successor: v is
        SIMPLE when the link is one closed cycle (no node starts a chain,
        one connected component) and BORDER when it is one open path (one
        chain start, one component, one node more than edges). Everything
        else is COMPLEX; a vertex in no face is UNREF. mve_tpu follows the
        chains vertex by vertex (a native loop, or a Python one); this
        gives the same classes (tests/test_torch_scene2pset.py).
        """
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        nv = self.mesh.num_vertices()
        faces = np.asarray(self.mesh.faces, np.int64).reshape(-1, 3)
        out = np.full(nv, self.UNREF, np.int8)
        if len(faces) == 0:
            return out
        # One record per corner: the vertex and its opposite edge, taken
        # at the vertex's first position in the face.
        v = faces.reshape(-1)
        first = np.where(faces[:, [0]] == faces, 0,
                         np.where(faces[:, [1]] == faces, 1, 2)).reshape(-1)
        f_of = np.repeat(np.arange(len(faces)), 3)
        a = faces[f_of, (first + 1) % 3]
        b = faces[f_of, (first + 2) % 3]
        n_edges = np.bincount(v, minlength=nv)

        def key(x, y):
            return x * nv + y

        start_keys = key(v, a)
        sorted_starts = np.sort(start_keys)
        dup_keys = sorted_starts[1:][sorted_starts[1:] == sorted_starts[:-1]]
        dup = np.zeros(nv, bool)
        dup[dup_keys // nv] = True
        end_keys = np.unique(key(v, b))
        pos = np.searchsorted(end_keys, start_keys).clip(max=len(end_keys) - 1)
        is_start = end_keys[pos] != start_keys
        n_starts = np.bincount(v[is_start], minlength=nv)
        # Link graph nodes are (vertex, neighbour) pairs.
        nodes, inv = np.unique(np.concatenate([start_keys, key(v, b)]), return_inverse=True)
        n_nodes = np.bincount(nodes // nv, minlength=nv)
        m = len(start_keys)
        graph = coo_matrix((np.ones(m), (inv[:m], inv[m:])), shape=(len(nodes), len(nodes)))
        n_labels, label = connected_components(graph, directed=False)
        comp = np.unique(nodes // nv * n_labels + label)
        n_comp = np.bincount(comp // n_labels, minlength=nv)

        used = n_edges > 0
        one = used & ~dup & (n_comp == 1)
        out[used] = self.COMPLEX
        out[one & (n_starts == 0)] = self.SIMPLE
        out[one & (n_starts == 1) & (n_nodes == n_edges + 1)] = self.BORDER
        return out
