"""Depth-map algorithms (reference: libs/mve/depthmap.h/.cc).

Vectorized implementations of: island cleanup, confidence cleanup,
bilateral filtering, depth convention conversion (z-depth <-> ray
length), pixel footprint / 3D position, depth-map triangulation with the
dd_factor discontinuity test, and boundary confidence ramps.

Depth maps are (H, W) float arrays, zero = unreconstructed. MVE's depth
convention stores the distance along the viewing ray (depthmap.h:55-64).

Host numpy as in mve_tpu, except the bilateral filter, which runs on the
device (device= "cuda" by default).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .mesh import TriangleMesh, MeshInfo


# ---------------------------------------------------------------------------
# pixel geometry (depthmap.cc:139-157)
# ---------------------------------------------------------------------------

def _pixel_rays(width, height, invproj):
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    return np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1) @ np.asarray(invproj).T


def pixel_footprint(depth_map: np.ndarray, invproj: np.ndarray) -> np.ndarray:
    """Per-pixel world footprint: invproj[0,0] * depth / |ray|."""
    dm = np.squeeze(np.asarray(depth_map))
    h, w = dm.shape
    rays = _pixel_rays(w, h, invproj)
    return np.asarray(invproj)[0, 0] * dm / np.linalg.norm(rays, axis=-1)


def pixel_3dpos(depth_map: np.ndarray, invproj: np.ndarray) -> np.ndarray:
    """Per-pixel camera-space 3D position: unit ray * depth. (H, W, 3)."""
    dm = np.squeeze(np.asarray(depth_map))
    h, w = dm.shape
    rays = _pixel_rays(w, h, invproj)
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays * dm[..., None]


def depthmap_convert_conventions(depth_map: np.ndarray, invproj: np.ndarray,
                                 to_mve: bool) -> np.ndarray:
    """z-depth <-> ray-length conversion (depthmap.h:55-64, impl :165-180)."""
    dm = np.squeeze(np.asarray(depth_map)).astype(np.float64)
    h, w = dm.shape
    rays = _pixel_rays(w, h, invproj)
    factor = np.linalg.norm(rays, axis=-1) / rays[..., 2]
    out = dm * factor if to_mve else dm / factor
    return np.where(dm > 0, out, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# cleanup (depthmap.cc:20-128)
# ---------------------------------------------------------------------------

def depthmap_cleanup(depth_map: np.ndarray, thres: int) -> np.ndarray:
    """Remove connected components of valid depth smaller than `thres`
    pixels (4-connectivity), matching depthmap_cleanup_grow."""
    from scipy import ndimage

    dm = np.squeeze(np.asarray(depth_map)).copy()
    valid = dm > 0
    labels, n = ndimage.label(valid, structure=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]))
    if n:
        sizes = np.bincount(labels.reshape(-1))
        small = sizes < thres
        small[0] = False
        dm[small[labels]] = 0.0
    return dm


def depthmap_confidence_clean(depth_map: np.ndarray, conf_map: np.ndarray,
                              thres: float) -> np.ndarray:
    """Zero depth where confidence < threshold (depthmap.h confidence clean)."""
    dm = np.squeeze(np.asarray(depth_map)).copy()
    cm = np.squeeze(np.asarray(conf_map))
    dm[cm < thres] = 0.0
    return dm


def _bilateral_kernel(dm, gc_sigma: float, pc_factor: float):
    H, W = dm.shape
    r = 2
    acc = torch.zeros_like(dm)
    wacc = torch.zeros_like(dm)
    padded = torch.nn.functional.pad(dm, (r, r, r, r))
    center_valid = dm > 0
    gc = torch.tensor(gc_sigma, dtype=torch.float32, device=dm.device)
    pc = torch.tensor(pc_factor, dtype=torch.float32, device=dm.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = padded[r + dy: r + dy + H, r + dx: r + dx + W]
            nb_valid = nb > 0
            gw = torch.exp(-(dx * dx + dy * dy) / (2 * gc * gc))
            # Photometric term: depth difference relative to local depth.
            dd = torch.abs(nb - dm)
            pw = torch.exp(-(dd * dd) / (2 * (pc * dm + 1e-12) ** 2))
            w = torch.where(nb_valid & center_valid, gw * pw, 0.0)
            acc = acc + nb * w
            wacc = wacc + w
    out = torch.where(wacc > 0, acc / torch.clamp(wacc, min=1e-30), 0.0)
    return torch.where(center_valid, out, 0.0)


def depthmap_bilateral_filter(depth_map: np.ndarray, gc_sigma: float = 2.0,
                              pc_factor: float = 0.01, device="cuda") -> np.ndarray:
    """Edge-preserving smoothing (depthmap.h:39-52): spatial gaussian x
    depth-difference gaussian scaled by local depth, on `device`."""
    dev = resolve_device(device)
    dm = np.squeeze(np.asarray(depth_map)).astype(np.float32)
    out = _bilateral_kernel(torch.from_numpy(np.ascontiguousarray(dm)).to(dev),
                            float(gc_sigma), float(pc_factor))
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# triangulation (depthmap.cc:183-420)
# ---------------------------------------------------------------------------

def depthmap_triangulate(depth_map: np.ndarray, invproj: np.ndarray,
                         dd_factor: float = 5.0,
                         color_image: np.ndarray | None = None):
    """Triangulate a (ray-length) depth map into a camera-space mesh.

    Follows depthmap_triangulate exactly: per 2x2 block, >= 3 valid
    depths required; 4-valid blocks split along the smaller-depth-diff
    diagonal; edges failing the discontinuity test
    (ddiff > footprint_min * dd_factor, x sqrt(2) on diagonals) drop the
    triangle. Returns (mesh, vertex_id_image).
    """
    dm = np.squeeze(np.asarray(depth_map)).astype(np.float64)
    H, W = dm.shape
    valid = dm > 0

    pos = pixel_3dpos(dm, invproj)  # (H, W, 3)
    fp = np.asarray(invproj)[0, 0] * dm / np.linalg.norm(_pixel_rays(W, H, invproj), axis=-1)

    # 2x2 block corner views (H-1, W-1).
    d = [dm[:-1, :-1], dm[:-1, 1:], dm[1:, :-1], dm[1:, 1:]]
    v = [valid[:-1, :-1], valid[:-1, 1:], valid[1:, :-1], valid[1:, 1:]]
    w_ = [fp[:-1, :-1], fp[:-1, 1:], fp[1:, :-1], fp[1:, 1:]]
    nvalid = sum(x.astype(np.int8) for x in v)

    # Triangle corner sets, indices into the 2x2 block (depthmap.cc tris).
    tris_def = [(0, 2, 1), (0, 3, 1), (0, 2, 3), (1, 2, 3)]

    def edge_ok(i1, i2):
        dmin = np.minimum(d[i1], d[i2])
        dmax = np.maximum(d[i1], d[i2])
        wmin = np.where(d[i1] <= d[i2], w_[i1], w_[i2])
        factor = dd_factor * (np.sqrt(2.0) if i1 + i2 == 3 else 1.0)
        if dd_factor <= 0:
            return np.ones_like(dmin, bool)
        return (dmax - dmin) <= wmin * factor

    tri_valid = []
    for (a, b, c) in tris_def:
        ok = v[a] & v[b] & v[c] & edge_ok(a, b) & edge_ok(b, c) & edge_ok(c, a)
        tri_valid.append(ok)

    # Which triangles fire per block (depthmap.cc:254-270): mask 7 ->
    # tris[0], 11 -> tris[1], 13 -> tris[2], 14 -> tris[3]; 15 -> split
    # along the smaller-depth-difference diagonal.
    mask = (v[0].astype(np.int8) | (v[1].astype(np.int8) << 1)
            | (v[2].astype(np.int8) << 2) | (v[3].astype(np.int8) << 3))
    use = [np.zeros_like(v[0]) for _ in range(4)]
    use[0] = (mask == 7) & tri_valid[0]
    use[1] = (mask == 11) & tri_valid[1]
    use[2] = (mask == 13) & tri_valid[2]
    use[3] = (mask == 14) & tri_valid[3]
    full = mask == 15
    ddiff1 = np.abs(d[0] - d[3])
    ddiff2 = np.abs(d[1] - d[2])
    # ddiff1 < ddiff2: split along 0-3 -> tris[1]={0,3,1} + tris[2]={0,2,3};
    # otherwise along 1-2 -> tris[0]={0,2,1} + tris[3]={1,2,3}.
    split_a = full & (ddiff1 < ddiff2)
    split_b = full & ~split_a
    use[1] = use[1] | (split_a & tri_valid[1])
    use[2] = use[2] | (split_a & tri_valid[2])
    use[0] = use[0] | (split_b & tri_valid[0])
    use[3] = use[3] | (split_b & tri_valid[3])

    # Collect vertices: all valid pixels referenced by some triangle.
    pix_index = np.full((H, W), -1, np.int64)
    corner_off = [(0, 0), (0, 1), (1, 0), (1, 1)]
    referenced = np.zeros((H, W), bool)
    for ti, (a, b, c) in enumerate(tris_def):
        blocks = use[ti]
        ys, xs = np.nonzero(blocks)
        for corner in (a, b, c):
            dy, dx = corner_off[corner]
            referenced[ys + dy, xs + dx] = True
    vy, vx = np.nonzero(referenced)
    pix_index[vy, vx] = np.arange(len(vy))

    faces = []
    for ti, (a, b, c) in enumerate(tris_def):
        ys, xs = np.nonzero(use[ti])
        if len(ys) == 0:
            continue
        ia = pix_index[ys + corner_off[a][0], xs + corner_off[a][1]]
        ib = pix_index[ys + corner_off[b][0], xs + corner_off[b][1]]
        ic = pix_index[ys + corner_off[c][0], xs + corner_off[c][1]]
        faces.append(np.stack([ia, ib, ic], axis=1))

    mesh = TriangleMesh()
    mesh.vertices = pos[vy, vx].astype(np.float32)
    mesh.faces = (np.concatenate(faces, axis=0).astype(np.int32)
                  if faces else np.zeros((0, 3), np.int32))
    if color_image is not None:
        ci = np.asarray(color_image)
        if ci.ndim == 2:
            ci = ci[:, :, None]
        cols = ci[vy, vx].astype(np.float32)
        if cols.shape[1] == 1:
            cols = np.repeat(cols, 3, axis=1)
        if cols.max(initial=0) > 1.0:
            cols = cols / 255.0
        mesh.vertex_colors = np.concatenate(
            [cols[:, :3], np.ones((len(cols), 1), np.float32)], axis=1)
    return mesh, pix_index


def rangegrid_triangulate(grid: np.ndarray, mesh: TriangleMesh,
                          angle_threshold_deg: float = 15.0) -> None:
    """Triangulate a range grid of vertex ids into `mesh`
    (depthmap.cc:420-495 rangegrid_triangulate).

    grid: (H, W) int; -1 marks missing vertices; other entries index
    mesh.vertices. Appends faces in place, dropping triangles whose
    minimal interior angle falls below the threshold (the reference's
    dm_is_depth_disc test).
    """
    g = np.asarray(grid, np.int64)
    H, W = g.shape
    verts = mesh.vertices
    v0 = g[:-1, :-1]
    v1 = g[:-1, 1:]
    v2 = g[1:, :-1]
    v3 = g[1:, 1:]
    valid = np.stack([v0 >= 0, v1 >= 0, v2 >= 0, v3 >= 0])
    nvalid = valid.sum(axis=0)
    mask = (valid[0].astype(np.int8) | (valid[1].astype(np.int8) << 1)
            | (valid[2].astype(np.int8) << 2) | (valid[3].astype(np.int8) << 3))

    def min_angle_ok(a, b, c):
        pa, pb, pc = verts[a], verts[b], verts[c]
        def ang(p, q, r):
            e1 = q - p
            e2 = r - p
            cosv = np.sum(e1 * e2, axis=-1) / np.maximum(
                np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1), 1e-30)
            return np.arccos(np.clip(cosv, -1, 1))
        m = np.minimum(np.minimum(ang(pa, pb, pc), ang(pb, pc, pa)), ang(pc, pa, pb))
        return m >= np.deg2rad(angle_threshold_deg)

    tris_def = [(v0, v2, v1), (v0, v3, v1), (v0, v2, v3), (v1, v2, v3)]
    use = [np.zeros_like(v0, bool) for _ in range(4)]
    use[0] = mask == 7
    use[1] = mask == 11
    use[2] = mask == 13
    use[3] = mask == 14
    full = mask == 15
    d1 = np.full(v0.shape, np.inf)
    d2 = np.full(v0.shape, np.inf)
    both = full
    if both.any():
        d1[both] = np.sum((verts[v0[both]] - verts[v3[both]]) ** 2, axis=-1)
        d2[both] = np.sum((verts[v1[both]] - verts[v2[both]]) ** 2, axis=-1)
    split_a = full & (d1 < d2)
    use[1] = use[1] | split_a
    use[2] = use[2] | split_a
    use[0] = use[0] | (full & ~split_a)
    use[3] = use[3] | (full & ~split_a)

    faces = [mesh.faces] if mesh.num_faces() else []
    # Reference winding ADDTRI(a,c,b): emit (a, b_swapped, c_swapped).
    order = [(0, 2, 1), (0, 3, 1), (0, 2, 3), (1, 2, 3)]
    grids = [v0, v1, v2, v3]
    for ti, (a, b, c) in enumerate(order):
        sel = use[ti]
        if not sel.any():
            continue
        fa = grids[a][sel]
        fb = grids[b][sel]
        fc = grids[c][sel]
        ok = min_angle_ok(fa, fb, fc)
        faces.append(np.stack([fa[ok], fc[ok], fb[ok]], axis=1).astype(np.int32))
    mesh.faces = np.concatenate(faces) if faces else np.zeros((0, 3), np.int32)


# ---------------------------------------------------------------------------
# boundary confidences / peeling (depthmap.cc:495-600)
# ---------------------------------------------------------------------------

def depthmap_mesh_confidences(mesh: TriangleMesh, iterations: int = 3) -> None:
    """Ramp vertex confidence from 0 at the mesh boundary to 1 over
    `iterations` adjacency rings (depthmap.cc:495-545)."""
    if iterations == 0:
        return
    n = mesh.num_vertices()
    info = MeshInfo(mesh)
    confs = np.ones(n, np.float32)
    ring = np.nonzero(info.vclass == MeshInfo.BORDER)[0]

    # Vertex adjacency from faces as CSR: each corner lists the face's
    # other two vertices.
    faces = np.asarray(mesh.faces, np.int64).reshape(-1, 3)
    src = np.repeat(faces.reshape(-1), 2)
    dst = faces[:, [1, 2, 2, 0, 0, 1]].reshape(-1)
    order = np.argsort(src, kind="stable")
    adj = dst[order]
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=off[1:])

    # Rings grow one adjacency step per iteration over vertices still at
    # 1.0 (mve_tpu's loop marks each once; the set is the same).
    for current in range(iterations):
        confs[ring] = current / iterations
        counts = off[ring + 1] - off[ring]
        idx = np.repeat(off[ring] - np.cumsum(counts) + counts, counts) + np.arange(counts.sum())
        nbrs = adj[idx]
        ring = np.unique(nbrs[confs[nbrs] == 1.0])
    mesh.vertex_confidences = confs


def depthmap_mesh_peeling(mesh: TriangleMesh, iterations: int) -> None:
    """Iteratively remove boundary triangles (depthmap.cc:550-600)."""
    for _ in range(iterations):
        info = MeshInfo(mesh)
        border = np.nonzero(info.vclass == MeshInfo.BORDER)[0]
        if len(border) == 0:
            return
        is_border = np.zeros(mesh.num_vertices(), bool)
        is_border[border] = True
        keep_faces = ~is_border[mesh.faces].any(axis=1)
        mesh.faces = mesh.faces[keep_faces]
    mesh.delete_unreferenced_vertices()
