"""Software triangle rasterizer (z-buffer, Gouraud headlight shading);
port of mve_tpu/render/rasterizer.py.

The reference draws through GL (libs/ogl/mesh_renderer.h); mve_tpu renders
with one jitted XLA program, a scan over fixed-size triangle chunks that
evaluates three edge functions for every pixel against each chunk and
keeps a z-buffer and a colour buffer. The port runs the same chunks in a
loop of plain PyTorch ops on the device, with one change of shape: each
chunk is evaluated only over the pixels of its screen bounding box (plus
a pixel of margin), computed on the host before the loop. A pixel outside
the box lies outside every triangle of the chunk, so the buffers are the
same as over the whole screen; the work drops from every pixel against
every triangle to each triangle's neighbourhood.

Per pixel the result is the nearest triangle, and at equal depth the one
of the lowest face index (jnp.argmin takes the first minimum within a
chunk, and the strict `<` against the z-buffer keeps the earlier chunk).
That does not depend on the chunk size, so the port takes larger chunks
than mve_tpu's (_chunk_size). Depth is interpolated in NDC
(screen-linear, as GL); normals and colours use perspective-correct
barycentrics. Shading is double-sided headlight Lambert.

Every device op is elementwise, or a gather, or an argmin over the chunk,
each rounding once, so the card and the CPU give the same buffers. The
host setup and the point and line overlays are mve_tpu's numpy, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = ["render_mesh", "overlay_points", "overlay_lines"]

_EPS_AREA = 1e-12


def _chunk_size(n_pix: int) -> int:
    """Triangles per step: up to 256 and 2^28 pixel-triangle elements, so
    that the eight float32 intermediates of a whole-screen chunk stay
    under 9 GB, and a frame of about 10^5 triangles takes hundreds of
    steps, not thousands, each a few dozen launches (mve_tpu takes at
    most 32 and 2^23). The image does not depend on it
    (tests/test_torch_render.py renders one mesh at several sizes)."""
    return max(1, min(256, (1 << 28) // max(n_pix, 1)))


def _chunk_windows(tri_xy, tri_valid, chunk, width, height):
    """(n_chunks, 4) int64 [x0, x1, y0, y1) pixel windows, one per chunk:
    the bounding box of the chunk's valid triangles, widened by a pixel
    against rounding and clipped to the screen; empty for a chunk with no
    valid triangle."""
    n_chunks = len(tri_xy) // chunk
    xy = tri_xy.reshape(n_chunks, chunk * 3, 2).astype(np.float64)
    ok = np.repeat(tri_valid.reshape(n_chunks, chunk), 3, axis=1)[..., None]
    lo = np.where(ok, xy, np.inf).min(axis=1)
    hi = np.where(ok, xy, -np.inf).max(axis=1)
    size = np.array([width, height], np.float64)
    # Pixel x's centre is x + 0.5: every centre in [lo, hi] and a pixel
    # beyond lies inside [floor(lo - 1.5), floor(hi + 0.5) + 1).
    start = np.floor(np.clip(lo - 1.5, 0.0, size)).astype(np.int64)
    stop = (np.floor(np.clip(hi + 0.5, -1.0, size - 1)) + 1).astype(np.int64)
    return np.stack([start[:, 0], stop[:, 0], start[:, 1], stop[:, 1]], axis=1)


def _rasterize(tri_xy, tri_z, tri_w, tri_normal, tri_color, tri_valid, view_rot,
               width, height, chunk, dev):
    """The chunk loop; tri_* padded to a multiple of `chunk` (numpy):
    tri_xy (F,3,2) screen coordinates, tri_z (F,3) NDC depths, tri_w
    (F,3) clip-space w, tri_normal/tri_color (F,3,3), tri_valid (F,).
    Returns (zbuf (H,W), cbuf (H,W,3)) float32 tensors on `dev`.

    The loop keeps, per pixel, the depth, face and barycentrics of the
    nearest triangle so far; one pass after the loop shades each pixel
    from its winner, with the values mve_tpu shades it with at the winner's
    chunk. The per-triangle terms of the edge functions and the area are
    computed once for all triangles."""
    windows = _chunk_windows(tri_xy, tri_valid, chunk, width, height)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    xy, z, w = to(tri_xy), to(tri_z), to(tri_w)
    a, b, c = xy[:, 0], xy[:, 1], xy[:, 2]
    # mve_tpu's edge(p, q, pix) = (q0 - p0) * (pix1 - p1) - (q1 - p1) * (pix0 - p0)
    # for the edges (b, c), (c, a), (a, b): per triangle, (q0 - p0, q1 - p1, p0, p1).
    edges = [(q[:, 0] - p[:, 0], q[:, 1] - p[:, 1], p[:, 0], p[:, 1])
             for p, q in ((b, c), (c, a), (a, b))]
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    big = torch.abs(area) > _EPS_AREA
    inv_area = torch.where(big, 1.0 / area, torch.zeros_like(area))
    usable = big & to(tri_valid)
    z0, z1, z2 = z[:, 0], z[:, 1], z[:, 2]

    zbuf = torch.full((height, width), float("inf"), dtype=torch.float32, device=dev)
    fbuf = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    lbuf = torch.zeros((3, height, width), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    cols = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    rows = torch.arange(height, dtype=torch.float32, device=dev) + 0.5

    for ci, (x0, x1, y0, y1) in enumerate(windows.tolist()):
        if x0 >= x1 or y0 >= y1:
            continue
        sl = slice(ci * chunk, (ci + 1) * chunk)
        py = rows[y0:y1, None, None]
        px = cols[None, x0:x1, None]
        ls = [(ex[sl] * (py - ay[sl]) - ey[sl] * (px - ax[sl])) * inv_area[sl]
              for ex, ey, ax, ay in edges]
        ok = (ls[0] >= 0) & (ls[1] >= 0) & (ls[2] >= 0) & usable[sl]
        zpix = torch.where(ok, ls[0] * z0[sl] + ls[1] * z1[sl] + ls[2] * z2[sl], inf)
        k = torch.argmin(zpix, dim=2, keepdim=True)
        zbest = torch.gather(zpix, 2, k)[..., 0]
        zwin = zbuf[y0:y1, x0:x1]
        hit = zbest < zwin
        zbuf[y0:y1, x0:x1] = torch.where(hit, zbest, zwin)
        fbuf[y0:y1, x0:x1] = torch.where(hit, k[..., 0] + ci * chunk, fbuf[y0:y1, x0:x1])
        lk = torch.cat([torch.gather(l, 2, k) for l in ls], dim=2).permute(2, 0, 1)
        lbuf[:, y0:y1, x0:x1] = torch.where(hit, lk, lbuf[:, y0:y1, x0:x1])

    # Shade every covered pixel from its winner (mve_tpu's shading, term
    # for term: perspective-correct barycentrics, then the headlight).
    f = torch.clamp(fbuf, min=0)
    lam = lbuf.permute(1, 2, 0)
    lam_p = lam / torch.clamp(w[f], min=1e-20)
    lam_p = lam_p / torch.clamp(lam_p[..., 0] + lam_p[..., 1] + lam_p[..., 2],
                                min=1e-20)[..., None]
    nk, ck = to(tri_normal)[f], to(tri_color)[f]          # (H, W, 3 corners, 3)
    normal = (lam_p[..., 0:1] * nk[..., 0, :] + lam_p[..., 1:2] * nk[..., 1, :]
              + lam_p[..., 2:3] * nk[..., 2, :])
    albedo = (lam_p[..., 0:1] * ck[..., 0, :] + lam_p[..., 1:2] * ck[..., 1, :]
              + lam_p[..., 2:3] * ck[..., 2, :])
    R0, R1, R2 = torch.from_numpy(np.asarray(view_rot, np.float32).copy()).to(dev)

    def dot3(u, v):
        return u[..., 0] * v[0] + u[..., 1] * v[1] + u[..., 2] * v[2]

    n0, n1, n2 = dot3(normal, R0), dot3(normal, R1), dot3(normal, R2)
    nz = torch.abs(n2) / torch.clamp(torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2), min=1e-12)
    shade = albedo * (0.25 + 0.75 * nz)[..., None]
    cbuf = torch.where((fbuf >= 0)[..., None], shade, torch.zeros_like(shade))
    return zbuf, cbuf


def render_mesh(mesh, view: np.ndarray, proj: np.ndarray,
                width: int, height: int, background=(1.0, 1.0, 1.0),
                default_color=(0.7, 0.7, 0.7), z_near: float = 1e-3, device="cuda"):
    """Render a TriangleMesh to (rgb float32 (H,W,3) in [0,1], depth (H,W)),
    both numpy, rasterized on `device`.

    Depth is NDC depth; pixels with no geometry hold +inf. Triangles with
    any vertex closer than z_near to the camera plane are culled (no
    clipping; adequate for outside-in viewing, as the reference's scene
    inspector).
    """
    dev = resolve_device(device)
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int64).reshape(-1, 3)
    if len(verts) == 0 or len(faces) == 0:
        rgb = np.ones((height, width, 3), np.float32) * np.asarray(
            background, np.float32)
        return rgb, np.full((height, width), np.inf, np.float32)

    mesh.ensure_normals()
    vnorm = np.asarray(mesh.vertex_normals, np.float32)
    if len(vnorm) != len(verts):
        vnorm = np.zeros_like(verts)
        vnorm[:, 2] = 1.0
    if mesh.has_vertex_colors():
        vcol = np.asarray(mesh.vertex_colors, np.float32)[:, :3]
    else:
        vcol = np.broadcast_to(
            np.asarray(default_color, np.float32), verts.shape).copy()

    vp = proj.astype(np.float64) @ view.astype(np.float64)
    hom = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], 1)
    clip = hom.astype(np.float64) @ vp.T                     # (V,4)
    viewz = hom.astype(np.float64) @ view.astype(np.float64)[2]  # (V,)
    w = clip[:, 3]
    safe_w = np.where(np.abs(w) > 1e-12, w, 1e-12)
    ndc = clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height
    sxy = np.stack([sx, sy], axis=-1).astype(np.float32)

    f = faces
    tri_xy = sxy[f]                                          # (F,3,2)
    tri_z = ndc[:, 2].astype(np.float32)[f]                  # (F,3)
    tri_w = w.astype(np.float32)[f]
    tri_normal = vnorm[f]
    tri_color = vcol[f]
    tri_valid = np.all(viewz[f] < -z_near, axis=1)

    chunk = _chunk_size(width * height)
    pad = (-len(f)) % chunk
    if pad:
        zpad = np.zeros
        tri_xy = np.concatenate([tri_xy, zpad((pad, 3, 2), np.float32)])
        tri_z = np.concatenate([tri_z, zpad((pad, 3), np.float32)])
        tri_w = np.concatenate([tri_w, np.ones((pad, 3), np.float32)])
        tri_normal = np.concatenate([tri_normal, zpad((pad, 3, 3), np.float32)])
        tri_color = np.concatenate([tri_color, zpad((pad, 3, 3), np.float32)])
        tri_valid = np.concatenate([tri_valid, np.zeros(pad, bool)])

    zbuf, cbuf = _rasterize(tri_xy, tri_z, tri_w, tri_normal, tri_color, tri_valid,
                            view[:3, :3], width, height, chunk, dev)
    zbuf = zbuf.cpu().numpy()
    rgb = cbuf.cpu().numpy()
    bg = np.asarray(background, np.float32)
    miss = ~np.isfinite(zbuf)
    rgb[miss] = bg
    return rgb, zbuf


def _project(points: np.ndarray, view: np.ndarray, proj: np.ndarray,
             width: int, height: int):
    """Project world points -> (screen xy, ndc z, in-front mask)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    hom = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    clip = hom @ (proj.astype(np.float64) @ view.astype(np.float64)).T
    w = clip[:, 3]
    front = w > 1e-9
    safe_w = np.where(np.abs(w) > 1e-12, w, 1e-12)
    ndc = clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height
    return np.stack([sx, sy], -1), ndc[:, 2], front


def overlay_points(rgb: np.ndarray, depth: np.ndarray, points, colors,
                   view: np.ndarray, proj: np.ndarray,
                   radius: int = 1, depth_bias: float = 1e-4) -> None:
    """Depth-tested point splats composited over a rendered frame in place.

    Covers the reference GUI's SfM-point overlay (umve scene inspector
    addin_sfm_renderer): points behind already-rendered geometry are
    hidden via the rasterizer's z-buffer.
    """
    h, w = depth.shape
    sxy, ndcz, front = _project(points, view, proj, w, h)
    colors = np.asarray(colors, np.float32).reshape(-1, 3)
    if len(colors) == 1:
        colors = np.broadcast_to(colors, (len(sxy), 3))
    colors = np.asarray(colors, np.float32)
    xi = np.round(sxy[:, 0]).astype(np.int64)
    yi = np.round(sxy[:, 1]).astype(np.int64)
    # Far-to-near scatter per splat offset: overlapping points resolve to
    # the nearest one (the splat loop is over the (2r+1)^2 offsets, not
    # the points).
    order = np.argsort(-ndcz, kind="stable")
    xi, yi, zz = xi[order], yi[order], ndcz[order]
    fr = front[order]
    cols = colors[order]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            px = xi + dx
            py = yi + dy
            ok = fr & (px >= 0) & (px < w) & (py >= 0) & (py < h)
            pxo, pyo = px[ok], py[ok]
            vis = zz[ok] <= depth[pyo, pxo] + depth_bias
            rgb[pyo[vis], pxo[vis]] = cols[ok][vis]


def overlay_lines(rgb: np.ndarray, depth: np.ndarray, segments, color,
                  view: np.ndarray, proj: np.ndarray,
                  samples_per_px: float = 1.5,
                  depth_bias: float = 1e-4) -> None:
    """Depth-tested world-space line segments drawn over a frame in place.

    segments: (N,2,3) world endpoints. Each segment is sampled densely in
    world space and projected, so perspective foreshortening and z-buffer
    occlusion are correct without a clipping stage. Covers the reference
    GUI's frusta/axis wireframes (ogl/render_tools.h).
    """
    h, w = depth.shape
    color = np.asarray(color, np.float32)
    vp = proj.astype(np.float64) @ view.astype(np.float64)
    w_eps = 1e-6
    for seg in np.asarray(segments, np.float64).reshape(-1, 2, 3):
        p0, p1 = seg
        # Clip against w > eps in clip space first: a behind-camera
        # endpoint's projection is meaningless and would collapse the
        # sample-count estimate for partially visible segments.
        w0 = vp[3] @ np.append(p0, 1.0)
        w1 = vp[3] @ np.append(p1, 1.0)
        if w0 <= w_eps and w1 <= w_eps:
            continue
        t0, t1 = 0.0, 1.0
        if w0 <= w_eps:
            t0 = (w_eps - w0) / (w1 - w0)
        elif w1 <= w_eps:
            t1 = (w_eps - w0) / (w1 - w0)
        p0c = p0 + (p1 - p0) * t0
        p1c = p0 + (p1 - p0) * t1
        s, _, f = _project(np.stack([p0c, p1c]), view, proj, w, h)
        if not f.any():
            continue
        n = int(max(2, min(4096, np.linalg.norm(s[1] - s[0]) * samples_per_px)))
        ts = np.linspace(0.0, 1.0, n)
        pts = p0c[None] * (1 - ts)[:, None] + p1c[None] * ts[:, None]
        sxy, ndcz, front = _project(pts, view, proj, w, h)
        xi = np.round(sxy[:, 0]).astype(int)
        yi = np.round(sxy[:, 1]).astype(int)
        ok = (front & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))
        xi, yi, zz = xi[ok], yi[ok], ndcz[ok]
        vis = zz <= depth[yi, xi] + depth_bias
        rgb[yi[vis], xi[vis]] = color
