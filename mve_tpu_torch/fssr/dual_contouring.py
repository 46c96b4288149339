"""Scale-adaptive iso-surface extraction via octree dual contouring
(port of mve_tpu/fssr/dual_contouring.py; host numpy, the implicit
function evaluated on the device by block_eval.py).

The reference extracts with octree-adaptive marching cubes and ~900
lines of cross-level edge stitching (iso_surface.cc:445-528). Dual
contouring (Ju et al. 2002) provides the same capability — a crack-free
surface whose resolution follows the octree's sample-scale-adaptive
leaves — with a far simpler cross-level story: one vertex per
sign-crossing leaf, one polygon per sign-crossing MINIMAL edge (an edge
not subdivided by any finer leaf), connecting the vertices of the (3-4)
leaves sharing that edge. Level transitions need no special cases.

Everything is vectorized numpy over flat edge/leaf arrays (the
round-1 version looped over edge lines in Python): minimal edges fall
out of one lexsort + neighbor comparisons, leaf adjacency out of a
level-by-level sorted-code lookup, and iso-crossing positions use the
same Hermite cubic root as the uniform extractor (hermite.h:17-43),
fed by the implicit function's analytic derivatives.

Per-vertex confidence/scale/color interpolate from the leaf's corner
voxel data, preserving fssrecon's downstream contracts (zero-conf
deletion, meshclean).
"""

from __future__ import annotations

import numpy as np

from ..core.mesh import TriangleMesh
from . import iso_octree
from .iso_surface import IsoSurface
from .octree import SampleOctree, build_octree
from .sample import SampleList

_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)

# Cube edges as corner-index pairs, grouped by axis.
_EDGES_BY_AXIS = {
    0: [(0, 1), (2, 3), (4, 5), (6, 7)],  # x-edges
    1: [(0, 2), (1, 3), (4, 6), (5, 7)],  # y-edges
    2: [(0, 4), (1, 5), (2, 6), (3, 7)],  # z-edges
}


class DualContouring:
    def __init__(self, samples: SampleList, max_level: int = 10,
                 interpolation: str = "cubic", device="cuda"):
        self.samples = samples
        self.device = device
        self.octree = build_octree(samples, max_level=max_level)
        self.interpolation = interpolation
        #: Sub-stage stats of the last extract_mesh call: n_corners,
        #: eval_ms (implicit function), extract_ms (topology).
        self.stats: dict = {}

    def extract_mesh(self) -> TriangleMesh:
        import time as _time

        t_start = _time.perf_counter()
        octree = self.octree
        L = len(octree.leaf_level)
        if L == 0:
            return TriangleMesh()
        finest = int(octree.leaf_level.max())
        unit = 1 << finest  # corner coords quantized at the finest level
        U1 = unit + 1

        # --- unique leaf corners in finest units.
        shift = (finest - octree.leaf_level.astype(np.int64))
        base = octree.leaf_coord << shift[:, None]       # (L, 3)
        step = (np.int64(1) << shift)                    # leaf edge length
        corners = base[:, None, :] + _CORNERS[None] * step[:, None, None]
        cflat = corners.reshape(-1, 3)
        code = (cflat[:, 2] * U1 + cflat[:, 1]) * U1 + cflat[:, 0]
        uniq_codes, inv = np.unique(code, return_inverse=True)
        corner_idx = inv.reshape(L, 8)                   # leaf corner -> row

        # --- evaluate the implicit function at unique corners.
        cz = uniq_codes // (U1 * U1)
        rem = uniq_codes % (U1 * U1)
        cy = rem // U1
        cx = rem % U1
        origin = octree.center - octree.root_size / 2.0
        fine_size = octree.root_size / unit
        positions = origin[None, :] + np.stack([cx, cy, cz], axis=-1) * fine_size
        t_eval0 = _time.perf_counter()
        data = iso_octree.evaluate_at_positions(self.samples, positions,
                                                device=self.device)
        t_eval1 = _time.perf_counter()
        self.stats["n_corners"] = int(len(positions))
        self.stats["eval_ms"] = int((t_eval1 - t_eval0) * 1000)
        value = data["value"]
        conf = data["conf"]
        deriv = data["deriv"]

        # --- per-leaf vertex: mass point of Hermite edge crossings.
        vals = value[corner_idx]                         # (L, 8)
        confs_ok = conf[corner_idx] > 0                  # (L, 8)
        leaf_ok = confs_ok.all(axis=1)
        inside = vals < 0

        cpos = positions[corner_idx]                     # (L, 8, 3)
        acc = np.zeros((L, 3))
        cnt = np.zeros(L)
        for axis, pairs in _EDGES_BY_AXIS.items():
            for (a, b) in pairs:
                ia = corner_idx[:, a]
                ib = corner_idx[:, b]
                cross = (inside[:, a] != inside[:, b]) & leaf_ok
                t = self._edge_roots(value[ia], value[ib], deriv[ia],
                                     deriv[ib], cpos[:, b] - cpos[:, a])
                p = cpos[:, a] + (cpos[:, b] - cpos[:, a]) * t[:, None]
                acc += np.where(cross[:, None], p, 0.0)
                cnt += cross
        has_vertex = (cnt > 0) & leaf_ok
        vert_pos = acc / np.maximum(cnt, 1)[:, None]
        leaf_vertex = np.full(L, -1, np.int64)
        leaf_vertex[has_vertex] = np.arange(int(has_vertex.sum()))
        vertices = vert_pos[has_vertex]

        # Vertex attributes: mean of the leaf's corner voxel data.
        def leaf_attr(arr):
            return arr[corner_idx].mean(axis=1)[has_vertex]

        v_conf = leaf_attr(conf)
        v_scale = leaf_attr(data["scale"])
        v_color = leaf_attr(data["color"])

        # --- leaf lookup: level-by-level sorted-code search. A query
        # point (finest units, cell coordinates) belongs to exactly one
        # leaf; probe each populated level's code table.
        lvl_tables = {}
        leaf_lv = octree.leaf_level.astype(np.int64)
        for lv in np.unique(leaf_lv):
            sel = np.nonzero(leaf_lv == lv)[0]
            c = octree.leaf_coord[sel].astype(np.int64)
            n = np.int64(1) << lv
            codes_lv = (c[:, 2] * n + c[:, 1]) * n + c[:, 0]
            order = np.argsort(codes_lv)
            lvl_tables[int(lv)] = (codes_lv[order], sel[order])

        def locate(pts):
            """pts: (Q, 3) int cell coords in finest units -> leaf index
            or -1 (outside root)."""
            out = np.full(len(pts), -1, np.int64)
            outside = ((pts < 0) | (pts >= unit)).any(axis=1)
            for lv, (codes_lv, rows) in lvl_tables.items():
                sh = finest - lv
                c = pts >> sh
                n = np.int64(1) << lv
                q = (c[:, 2] * n + c[:, 1]) * n + c[:, 0]
                j = np.searchsorted(codes_lv, q)
                j = np.clip(j, 0, len(codes_lv) - 1)
                hit = (codes_lv[j] == q) & (out < 0) & ~outside
                out[hit] = rows[j[hit]]
            return out

        # --- minimal edges per axis, fully vectorized.
        faces = []
        corner_lookup = uniq_codes  # sorted unique corner codes

        def corner_row(pts):
            q = (pts[:, 2] * U1 + pts[:, 1]) * U1 + pts[:, 0]
            j = np.searchsorted(corner_lookup, q)
            j = np.clip(j, 0, len(corner_lookup) - 1)
            ok = corner_lookup[j] == q
            return j, ok

        for axis, pairs in _EDGES_BY_AXIS.items():
            perp = [ax for ax in range(3) if ax != axis]
            # All leaf edges along this axis: start point + length.
            starts = np.concatenate(
                [corners[:, a, :] for (a, b) in pairs])       # (4L, 3)
            lens = np.tile(step, 4)                           # (4L,)
            # Line key + start along axis.
            line = (starts[:, perp[0]] * U1 + starts[:, perp[1]])
            s0 = starts[:, axis]
            # Unique edges sorted by (line, start, length).
            key = (line * U1 + s0) * U1 + lens
            ukey, first_idx = np.unique(key, return_index=True)
            uline = line[first_idx]
            us0 = s0[first_idx]
            ulen = lens[first_idx]
            # Minimal tests against sorted neighbors:
            # (a) same (line, start) group: only its shortest survives;
            # (b) next different-start edge on the same line must start
            #     at/after this edge's end.
            same_start_prev = np.zeros(len(ukey), bool)
            same_start_prev[1:] = (uline[1:] == uline[:-1]) & (us0[1:] == us0[:-1])
            # next different start per row: since same-(line,start) runs
            # are sorted by length, the FIRST of each run is the group's
            # minimal candidate; scan for the next row with a different
            # start on the same line.
            # Vectorized: index of next row with different (line,start).
            grp_change = np.ones(len(ukey), bool)
            grp_change[:-1] = (uline[:-1] != uline[1:]) | (us0[:-1] != us0[1:])
            # next_diff[i] = smallest j>i with grp_change boundary crossed
            nxt = np.arange(1, len(ukey) + 1)
            # rows where the next row starts a new (line,start) group are
            # exactly rows with grp_change True; for rows inside a run the
            # next different row is the run end + 1. Compute via cummax of
            # run-end indices (runs are short; use np.maximum.accumulate
            # on reversed boundaries).
            run_end = np.where(grp_change, np.arange(len(ukey)),
                               len(ukey))
            run_end = np.minimum.accumulate(run_end[::-1])[::-1]
            nxt = run_end + 1
            nxt_line = np.full(len(ukey), -1, np.int64)
            nxt_s0 = np.full(len(ukey), -1, np.int64)
            valid_nxt = nxt < len(ukey)
            nxt_line[valid_nxt] = uline[nxt[valid_nxt]]
            nxt_s0[valid_nxt] = us0[nxt[valid_nxt]]
            contained = valid_nxt & (nxt_line == uline) & (nxt_s0 < us0 + ulen)
            minimal = ~same_start_prev & ~contained
            m_line0 = uline[minimal] // U1
            m_line1 = uline[minimal] % U1
            m_s0 = us0[minimal]
            m_len = ulen[minimal]
            E = int(minimal.sum())
            if E == 0:
                continue

            # Edge endpoint corners: sign change + confidence gate.
            p_lo = np.zeros((E, 3), np.int64)
            p_lo[:, axis] = m_s0
            p_lo[:, perp[0]] = m_line0
            p_lo[:, perp[1]] = m_line1
            p_hi = p_lo.copy()
            p_hi[:, axis] += m_len
            ia, ok_a = corner_row(p_lo)
            ib, ok_b = corner_row(p_hi)
            ok = ok_a & ok_b
            ok &= (conf[ia] > 0) & (conf[ib] > 0)
            ok &= (value[ia] < 0) != (value[ib] < 0)
            if not ok.any():
                continue
            ia, ib = ia[ok], ib[ok]
            # A finest cell whose [c, c+1) span lies inside the edge.
            mid_ax = m_s0[ok] + m_len[ok] // 2
            # The 4 leaves around the edge: probe the cells whose corner
            # touches the edge midpoint (offsets in the two perp dims).
            E2 = int(ok.sum())
            probes = np.zeros((4, E2, 3), np.int64)
            for k, (d0, d1) in enumerate(((-1, -1), (0, -1), (0, 0), (-1, 0))):
                probes[k, :, axis] = mid_ax
                probes[k, :, perp[0]] = m_line0[ok] + d0
                probes[k, :, perp[1]] = m_line1[ok] + d1
            leaves = locate(probes.reshape(-1, 3)).reshape(4, E2)
            vids = np.where(leaves >= 0, leaf_vertex[np.maximum(leaves, 0)], -1)
            # Drop duplicate leaves (coarse leaf spanning two probe cells):
            # mark repeats of an earlier column as -1.
            for k in range(1, 4):
                for j in range(k):
                    dup = leaves[k] == leaves[j]
                    vids[k][dup & (leaves[k] >= 0)] = -1
            n_ok = (vids >= 0).sum(axis=0)
            use = n_ok >= 3
            if not use.any():
                continue
            vids = vids[:, use]
            ia_u = ia[use]
            E3 = int(use.sum())

            # Ring order: the probe order ((-1,-1),(0,-1),(0,0),(-1,0))
            # already walks around the edge axis; compact the (3-4) valid
            # entries preserving that cyclic order.
            flip = value[ia_u] >= 0  # lower end outside -> flip winding
            if axis == 1:
                flip = ~flip
            ring = np.full((4, E3), -1, np.int64)
            pos = np.zeros(E3, np.int64)
            for k in range(4):
                v = vids[k]
                put = v >= 0
                ring[pos[put], np.nonzero(put)[0]] = v[put]
                pos += put.astype(np.int64)
            # Fan-triangulate: (0,1,2) and (0,2,3) where present.
            tri1 = np.stack([ring[0], ring[1], ring[2]], axis=1)
            faces.append(np.where(flip[:, None],
                                  tri1[:, ::-1], tri1))
            quad = ring[3] >= 0
            if quad.any():
                tri2 = np.stack([ring[0][quad], ring[2][quad],
                                 ring[3][quad]], axis=1)
                faces.append(np.where(flip[quad][:, None],
                                      tri2[:, ::-1], tri2))

        mesh = TriangleMesh()
        mesh.vertices = vertices.astype(np.float32)
        mesh.faces = (np.concatenate(faces).astype(np.int32)
                      if faces else np.zeros((0, 3), np.int32))
        mesh.vertex_confidences = v_conf.astype(np.float32)
        mesh.vertex_values = v_scale.astype(np.float32)
        mesh.vertex_colors = np.concatenate(
            [np.clip(v_color, 0, 1), np.ones((len(vertices), 1))],
            axis=1).astype(np.float32)
        f = mesh.faces
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        mesh.faces = f[ok]
        mesh.delete_unreferenced_vertices()
        self.stats["extract_ms"] = int(
            (_time.perf_counter() - t_start) * 1000) - self.stats.get("eval_ms", 0)
        return mesh

    # ------------------------------------------------------------------
    def _edge_roots(self, va, vb, da, db, edge_vec):
        """Iso-crossing parameter along corner-to-corner edges with the
        configured interpolant (linear or Hermite cubic, hermite.h)."""
        denom = va - vb
        t = va / np.where(np.abs(denom) < 1e-30, 1e-30, denom)
        if self.interpolation == "cubic":
            t = IsoSurface._hermite_roots(va, vb, da, db, edge_vec, t)
        return np.clip(t, 0.0, 1.0)
