"""Mesh I/O: PLY (binary/ascii), OFF, OBJ, NPTS (reference: libs/mve/mesh_io*).

PLY is the workhorse format — depth-map point sets with per-vertex value,
confidence, normal and scale properties flow between pipeline stages
through it (mesh_io_ply.h:30-114). The writer emits binary_little_endian
by default; the reader handles ascii and both binary byte orders, and
tolerates unknown properties by skipping them.

Dispatch by extension mirrors mesh_io.h:25-31.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List

import numpy as np

from .mesh import TriangleMesh

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


# ---------------------------------------------------------------------------
# PLY reader
# ---------------------------------------------------------------------------

def load_ply_mesh(path: str) -> TriangleMesh:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise IOError(f"{path}: not a PLY file")
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise IOError(f"{path}: unterminated PLY header")
    header_lines = data[:header_end].decode("ascii", "replace").splitlines()
    body_off = data.find(b"\n", header_end) + 1

    fmt = None
    elements: List[Dict] = []
    for line in header_lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append({"name": parts[1], "count": int(parts[2]), "props": []})
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1]["props"].append(("list", _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]], parts[4]))
            else:
                elements[-1]["props"].append(("scalar", _PLY_TYPES[parts[1]], parts[2]))

    mesh = TriangleMesh()
    if fmt == "ascii":
        _read_ply_ascii(data[body_off:], elements, mesh)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        _read_ply_binary(data[body_off:], elements, mesh, endian)
    return mesh


def _assign_vertex_props(mesh: TriangleMesh, names: List[str], cols: np.ndarray) -> None:
    def col(name):
        return cols[:, names.index(name)] if name in names else None

    n = len(cols)
    mesh.vertices = np.stack([col("x"), col("y"), col("z")], axis=1).astype(np.float32)
    if "nx" in names:
        mesh.vertex_normals = np.stack([col("nx"), col("ny"), col("nz")], axis=1).astype(np.float32)
    if "red" in names or "r" in names:
        r = col("red") if "red" in names else col("r")
        g = col("green") if "green" in names else col("g")
        b = col("blue") if "blue" in names else col("b")
        a = col("alpha")
        scale = 255.0 if r.max(initial=0) > 1.0 else 1.0
        rgba = np.stack([r, g, b, a if a is not None else np.full(n, scale)], axis=1) / scale
        mesh.vertex_colors = rgba.astype(np.float32)
    if "confidence" in names:
        mesh.vertex_confidences = col("confidence").astype(np.float32)
    if "value" in names:
        mesh.vertex_values = col("value").astype(np.float32)
    # FSSR sample scale rides in "value" (mesh_io_ply writer maps values
    # to the "value" property); some tools use "radius"/"scale".
    if "scale" in names and "value" not in names:
        mesh.vertex_values = col("scale").astype(np.float32)


def _read_ply_binary(body: bytes, elements, mesh, endian) -> None:
    off = 0
    for el in elements:
        props = el["props"]
        count = el["count"]
        if all(p[0] == "scalar" for p in props):
            dtype = np.dtype([(p[2], endian + p[1]) for p in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
            off += dtype.itemsize * count
            if el["name"] == "vertex":
                names = [p[2] for p in props]
                cols = np.stack([arr[n].astype(np.float64) for n in names], axis=1)
                _assign_vertex_props(mesh, names, cols)
        elif el["name"] == "face" and len(props) == 1 and props[0][0] == "list":
            _, cnt_t, idx_t, _ = props[0]
            cnt_size = int(cnt_t[1])
            idx_size = int(idx_t[1])
            faces = []
            cnt_dtype = np.dtype(endian + cnt_t)
            idx_dtype = np.dtype(endian + idx_t)
            # Fast path: try fixed triangle stride first.
            stride = cnt_size + 3 * idx_size
            if off + stride * count <= len(body):
                raw = np.frombuffer(body, dtype=np.uint8, count=stride * count, offset=off)
                counts = raw.reshape(count, stride)[:, :cnt_size].copy().view(cnt_dtype).reshape(count)
                if np.all(counts == 3):
                    idx = raw.reshape(count, stride)[:, cnt_size:].copy().view(idx_dtype)
                    mesh.faces = idx.reshape(count, 3).astype(np.int32)
                    off += stride * count
                    continue
            # Ragged fallback.
            for _ in range(count):
                n = int(np.frombuffer(body, dtype=cnt_dtype, count=1, offset=off)[0])
                off += cnt_size
                poly = np.frombuffer(body, dtype=idx_dtype, count=n, offset=off).astype(np.int64)
                off += idx_size * n
                for k in range(1, n - 1):  # fan-triangulate
                    faces.append((poly[0], poly[k], poly[k + 1]))
            mesh.faces = np.array(faces, np.int32).reshape(-1, 3)
        else:
            # Mixed scalar/list element we don't understand: parse & skip.
            for _ in range(count):
                for p in props:
                    if p[0] == "scalar":
                        off += int(p[1][1])
                    else:
                        n = int(np.frombuffer(body, dtype=np.dtype(endian + p[1]), count=1, offset=off)[0])
                        off += int(p[1][1]) + n * int(p[2][1])


def _read_ply_ascii(body: bytes, elements, mesh) -> None:
    tokens = body.split()
    pos = 0
    for el in elements:
        props = el["props"]
        count = el["count"]
        if el["name"] == "vertex" and all(p[0] == "scalar" for p in props):
            names = [p[2] for p in props]
            ncols = len(names)
            flat = np.array(tokens[pos : pos + count * ncols], np.float64)
            pos += count * ncols
            _assign_vertex_props(mesh, names, flat.reshape(count, ncols))
        elif el["name"] == "face":
            faces = []
            for _ in range(count):
                n = int(tokens[pos]); pos += 1
                poly = [int(t) for t in tokens[pos : pos + n]]; pos += n
                for k in range(1, n - 1):
                    faces.append((poly[0], poly[k], poly[k + 1]))
            mesh.faces = np.array(faces, np.int32).reshape(-1, 3)
        else:
            for _ in range(count):
                for p in props:
                    if p[0] == "scalar":
                        pos += 1
                    else:
                        n = int(tokens[pos]); pos += 1 + n


# ---------------------------------------------------------------------------
# PLY writer (mesh_io_ply.cc save_ply_mesh)
# ---------------------------------------------------------------------------

def save_ply_mesh(mesh: TriangleMesh, path: str, fmt: str = "binary",
                  write_normals: bool = None, write_colors: bool = None,
                  write_confidences: bool = None, write_values: bool = None) -> None:
    n = mesh.num_vertices()
    use_normals = mesh.has_vertex_normals() if write_normals is None else write_normals
    use_colors = mesh.has_vertex_colors() if write_colors is None else write_colors
    use_conf = mesh.has_vertex_confidences() if write_confidences is None else write_confidences
    use_vals = mesh.has_vertex_values() if write_values is None else write_values

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if fmt == "binary" else "format ascii 1.0")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if use_normals:
        header += ["property float nx", "property float ny", "property float nz"]
    if use_colors:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if use_conf:
        header.append("property float confidence")
    if use_vals:
        header.append("property float value")
    if mesh.num_faces() > 0:
        header.append(f"element face {mesh.num_faces()}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if fmt == "binary":
            if n == 0:
                return  # header-only PLY (no vertex rows to write)
            cols = [mesh.vertices.astype("<f4")]
            if use_normals:
                cols.append(mesh.vertex_normals.astype("<f4"))
            fixed = np.concatenate(cols, axis=1) if cols else None
            colors_u8 = None
            if use_colors:
                colors_u8 = np.clip(mesh.vertex_colors[:, :3] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            extra = []
            if use_conf:
                extra.append(mesh.vertex_confidences.astype("<f4")[:, None])
            if use_vals:
                extra.append(mesh.vertex_values.astype("<f4")[:, None])
            # Build one structured row buffer.
            row_parts = [fixed.view(np.uint8).reshape(n, -1)]
            if colors_u8 is not None:
                row_parts.append(colors_u8)
            for e in extra:
                row_parts.append(e.view(np.uint8).reshape(n, -1))
            f.write(np.concatenate(row_parts, axis=1).tobytes())
            if mesh.num_faces() > 0:
                faces = mesh.faces.astype("<i4")
                buf = np.empty((len(faces), 13), np.uint8)
                buf[:, 0] = 3
                buf[:, 1:] = faces.view(np.uint8).reshape(len(faces), 12)
                f.write(buf.tobytes())
        else:
            lines = []
            for i in range(n):
                parts = [f"{x:g}" for x in mesh.vertices[i]]
                if use_normals:
                    parts += [f"{x:g}" for x in mesh.vertex_normals[i]]
                if use_colors:
                    parts += [str(int(np.clip(c * 255 + 0.5, 0, 255))) for c in mesh.vertex_colors[i, :3]]
                if use_conf:
                    parts.append(f"{mesh.vertex_confidences[i]:g}")
                if use_vals:
                    parts.append(f"{mesh.vertex_values[i]:g}")
                lines.append(" ".join(parts))
            for face in mesh.faces:
                lines.append("3 " + " ".join(str(int(x)) for x in face))
            f.write(("\n".join(lines) + "\n").encode())


# ---------------------------------------------------------------------------
# OFF (mesh_io_off.cc)
# ---------------------------------------------------------------------------

def load_off_mesh(path: str) -> TriangleMesh:
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "OFF":
        raise IOError(f"{path}: not an OFF file")
    nv, nf = int(tokens[1]), int(tokens[2])
    pos = 4
    mesh = TriangleMesh()
    mesh.vertices = np.array(tokens[pos : pos + nv * 3], np.float32).reshape(nv, 3)
    pos += nv * 3
    faces = []
    for _ in range(nf):
        n = int(tokens[pos]); pos += 1
        poly = [int(t) for t in tokens[pos : pos + n]]; pos += n
        for k in range(1, n - 1):
            faces.append((poly[0], poly[k], poly[k + 1]))
    mesh.faces = np.array(faces, np.int32).reshape(-1, 3)
    return mesh


def save_off_mesh(mesh: TriangleMesh, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"OFF\n{mesh.num_vertices()} {mesh.num_faces()} 0\n")
        for v in mesh.vertices:
            f.write(f"{v[0]:g} {v[1]:g} {v[2]:g}\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------------
# OBJ (mesh_io_obj.cc — positions/normals/texcoords + triangular faces)
# ---------------------------------------------------------------------------

def load_obj_mesh(path: str) -> TriangleMesh:
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    mesh = TriangleMesh()
    mesh.vertices = np.array(verts, np.float32).reshape(-1, 3)
    if len(normals) == len(verts):
        mesh.vertex_normals = np.array(normals, np.float32).reshape(-1, 3)
    mesh.faces = np.array(faces, np.int32).reshape(-1, 3)
    return mesh


def save_obj_mesh(mesh: TriangleMesh, path: str) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]:g} {v[1]:g} {v[2]:g}\n")
        if mesh.has_vertex_normals():
            for vn in mesh.vertex_normals:
                f.write(f"vn {vn[0]:g} {vn[1]:g} {vn[2]:g}\n")
        for face in mesh.faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


# ---------------------------------------------------------------------------
# NPTS (mesh_io_npts.cc — "x y z nx ny nz" per line point clouds)
# ---------------------------------------------------------------------------

def load_npts_mesh(path: str, binary: bool = False) -> TriangleMesh:
    mesh = TriangleMesh()
    if binary:
        data = np.fromfile(path, dtype="<f4").reshape(-1, 6)
    else:
        data = np.loadtxt(path, dtype=np.float32).reshape(-1, 6)
    mesh.vertices = data[:, :3].copy()
    mesh.vertex_normals = data[:, 3:6].copy()
    return mesh


def save_npts_mesh(mesh: TriangleMesh, path: str, binary: bool = False) -> None:
    mesh.ensure_normals()
    data = np.concatenate([mesh.vertices, mesh.vertex_normals], axis=1).astype("<f4")
    if binary:
        data.tofile(path)
    else:
        np.savetxt(path, data, fmt="%g")


# ---------------------------------------------------------------------------
# .xf transform files (mesh_io_ply.h:30-114 — a 4x4 row-major transform
# stored next to range-scan PLYs; applied on load by alignment tools)
# ---------------------------------------------------------------------------

def load_xf(path: str) -> np.ndarray:
    vals = np.loadtxt(path, dtype=np.float64)
    return vals.reshape(4, 4)


def save_xf(matrix: np.ndarray, path: str) -> None:
    np.savetxt(path, np.asarray(matrix, np.float64).reshape(4, 4), fmt="%.9g")


def load_ply_with_xf(path: str) -> TriangleMesh:
    """Load a PLY and apply its sibling .xf transform if present."""
    mesh = load_ply_mesh(path)
    xf_path = os.path.splitext(path)[0] + ".xf"
    if os.path.isfile(xf_path):
        from .mesh_tools import mesh_transform

        mesh_transform(mesh, load_xf(xf_path))
    return mesh


# ---------------------------------------------------------------------------
# SMF (mesh_io_smf.cc — "v x y z" / "f a b c", 1-indexed)
# ---------------------------------------------------------------------------

def load_smf_mesh(path: str) -> TriangleMesh:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(x) - 1 for x in parts[1:4]])
    mesh = TriangleMesh()
    mesh.vertices = np.array(verts, np.float32).reshape(-1, 3)
    mesh.faces = np.array(faces, np.int32).reshape(-1, 3)
    return mesh


def save_smf_mesh(mesh: TriangleMesh, path: str) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]:g} {v[1]:g} {v[2]:g}\n")
        for face in mesh.faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


# ---------------------------------------------------------------------------
# PBRT (mesh_io_pbrt.cc — trianglemesh shape, export only like the ref)
# ---------------------------------------------------------------------------

def save_pbrt_mesh(mesh: TriangleMesh, path: str) -> None:
    with open(path, "w") as f:
        f.write('Shape "trianglemesh"\n"point3 P" [\n')
        for v in mesh.vertices:
            f.write(f"  {v[0]:g} {v[1]:g} {v[2]:g}\n")
        f.write(']\n"integer indices" [\n')
        for face in mesh.faces:
            f.write(f"  {face[0]} {face[1]} {face[2]}\n")
        f.write("]\n")


# ---------------------------------------------------------------------------
# GLB (mesh_io_glb.cc — binary glTF 2.0 container, export only)
# ---------------------------------------------------------------------------

def save_glb_mesh(mesh: TriangleMesh, path: str) -> None:
    import json as _json

    verts = np.ascontiguousarray(mesh.vertices, "<f4")
    faces = np.ascontiguousarray(mesh.faces, "<u4")
    has_colors = mesh.has_vertex_colors()
    buffers = [verts.tobytes(), faces.tobytes()]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": int(len(verts)),
         "type": "VEC3",
         "min": [float(x) for x in verts.min(axis=0)] if len(verts) else [0, 0, 0],
         "max": [float(x) for x in verts.max(axis=0)] if len(verts) else [0, 0, 0]},
        {"bufferView": 1, "componentType": 5125,
         "count": int(faces.size), "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if has_colors:
        colors = np.ascontiguousarray(mesh.vertex_colors[:, :4], "<f4")
        buffers.append(colors.tobytes())
        accessors.append({"bufferView": 2, "componentType": 5126,
                          "count": int(len(colors)), "type": "VEC4"})
        attributes["COLOR_0"] = 2

    views = []
    offset = 0
    for b in buffers:
        pad = (-len(b)) % 4
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(b)})
        offset += len(b) + pad
    bin_blob = b"".join(b + b"\x00" * ((-len(b)) % 4) for b in buffers)

    gltf = {
        "asset": {"version": "2.0", "generator": "mve_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "indices": 1}]}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(bin_blob)}],
    }
    json_blob = _json.dumps(gltf).encode()
    json_blob += b" " * ((-len(json_blob)) % 4)
    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)


# ---------------------------------------------------------------------------
# Dispatch (mesh_io.h:25-31)
# ---------------------------------------------------------------------------

def load_mesh(path: str) -> TriangleMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply_mesh(path)
    if ext == ".off":
        return load_off_mesh(path)
    if ext == ".obj":
        return load_obj_mesh(path)
    if ext == ".npts":
        return load_npts_mesh(path)
    if ext == ".bnpts":
        return load_npts_mesh(path, binary=True)
    if ext == ".smf":
        return load_smf_mesh(path)
    raise ValueError(f"unsupported mesh format: {ext}")


def save_mesh(mesh: TriangleMesh, path: str, **kw) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        save_ply_mesh(mesh, path, **kw)
    elif ext == ".off":
        save_off_mesh(mesh, path)
    elif ext == ".obj":
        save_obj_mesh(mesh, path)
    elif ext == ".npts":
        save_npts_mesh(mesh, path)
    elif ext == ".bnpts":
        save_npts_mesh(mesh, path, binary=True)
    elif ext == ".smf":
        save_smf_mesh(mesh, path)
    elif ext == ".pbrt":
        save_pbrt_mesh(mesh, path)
    elif ext == ".glb":
        save_glb_mesh(mesh, path)
    else:
        raise ValueError(f"unsupported mesh format: {ext}")
