"""FSSR point samples and streaming input (reference: libs/fssr/sample.h,
sample_io.cc; port of mve_tpu/fssr/sample.py, host numpy).

Samples are struct-of-arrays: pos (N,3), normal (N,3), color (N,3),
scale (N,), confidence (N,). PLY input maps the "value" property to scale
and "confidence" to confidence (sample_io.cc:160-162), with the same
cleaning rules: drop zero/invalid normals, non-positive scales and
(optionally) zero confidences.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import mesh_io
from ..core.mesh import TriangleMesh


@dataclasses.dataclass
class SampleList:
    pos: np.ndarray        # (N, 3) float32
    normal: np.ndarray     # (N, 3) float32, unit
    color: np.ndarray      # (N, 3) float32
    scale: np.ndarray      # (N,) float32
    confidence: np.ndarray # (N,) float32

    def __len__(self):
        return len(self.pos)

    def subset(self, mask) -> "SampleList":
        """The samples that a boolean mask (or an index array) selects."""
        return SampleList(
            pos=self.pos[mask], normal=self.normal[mask],
            color=self.color[mask], scale=self.scale[mask],
            confidence=self.confidence[mask])


# Backwards-compatible alias mirroring the reference's single-sample type.
Sample = SampleList


def samples_from_mesh(mesh: TriangleMesh, scale_factor: float = 1.0,
                      drop_zero_conf: bool = True) -> SampleList:
    """Convert a point-set mesh (scene2pset output) into samples
    (sample_io.cc:30-80 SampleIO::read semantics)."""
    if not mesh.has_vertex_normals():
        raise ValueError("Vertex normals missing!")
    if not mesh.has_vertex_values():
        raise ValueError("Vertex scale missing!")
    n = mesh.num_vertices()
    conf = (mesh.vertex_confidences if mesh.has_vertex_confidences()
            else np.ones(n, np.float32))
    color = (mesh.vertex_colors[:, :3] if mesh.has_vertex_colors()
             else np.full((n, 3), 0.5, np.float32))
    scale = mesh.vertex_values * scale_factor

    norm_len = np.linalg.norm(mesh.vertex_normals, axis=1)
    keep = np.isfinite(scale) & (scale > 0) & (norm_len > 1e-6)
    keep &= np.isfinite(mesh.vertices).all(axis=1)
    if drop_zero_conf:
        keep &= conf > 0
    normals = mesh.vertex_normals[keep] / np.maximum(norm_len[keep][:, None], 1e-30)
    return SampleList(
        pos=mesh.vertices[keep].astype(np.float32),
        normal=normals.astype(np.float32),
        color=color[keep].astype(np.float32),
        scale=scale[keep].astype(np.float32),
        confidence=conf[keep].astype(np.float32),
    )


def _clean_chunk(cols: dict, scale_factor: float,
                 drop_zero_conf: bool) -> SampleList:
    """Apply the sample_io.cc cleaning rules to one chunk of columns."""
    pos = cols["pos"]
    normal = cols["normal"]
    scale = cols["scale"] * scale_factor
    n = len(pos)
    conf = cols.get("confidence")
    if conf is None:
        conf = np.ones(n, np.float32)
    color = cols.get("color")
    if color is None:
        color = np.full((n, 3), 0.5, np.float32)
    norm_len = np.linalg.norm(normal, axis=1)
    keep = np.isfinite(scale) & (scale > 0) & (norm_len > 1e-6)
    keep &= np.isfinite(pos).all(axis=1)
    if drop_zero_conf:
        keep &= conf > 0
    return SampleList(
        pos=pos[keep].astype(np.float32),
        normal=(normal[keep] / np.maximum(norm_len[keep][:, None], 1e-30)
                ).astype(np.float32),
        color=color[keep].astype(np.float32),
        scale=scale[keep].astype(np.float32),
        confidence=conf[keep].astype(np.float32),
    )


def stream_samples_from_ply(path: str, scale_factor: float = 1.0,
                            chunk_size: int = 1 << 20,
                            drop_zero_conf: bool = True):
    """Yield cleaned SampleList chunks of <= chunk_size samples without
    materializing the whole point set (the reference streams PLY input
    sample-by-sample, sample_io.cc:471 next_sample; here the unit of
    streaming is a vectorized chunk).

    Handles binary PLY with an all-scalar vertex element — the format
    every scene2pset/fssrecon pset uses. ASCII or exotic layouts fall
    back to one whole-file chunk via load_ply_mesh.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"ply"):
            raise IOError(f"{path}: not a PLY file")
        fmt = None
        elements = []
        while True:
            line = f.readline()
            if not line:
                raise IOError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "end_header":
                break
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append({"name": parts[1], "count": int(parts[2]),
                                 "props": []})
            elif parts[0] == "property" and elements:
                elements[-1]["props"].append(parts[1:])

        vertex = next((el for el in elements if el["name"] == "vertex"), None)
        streamable = (
            fmt in ("binary_little_endian", "binary_big_endian")
            and vertex is not None
            and elements and elements[0] is vertex
            and all(p[0] != "list" for p in vertex["props"]))
        if not streamable:
            yield samples_from_mesh(mesh_io.load_ply_mesh(path),
                                    scale_factor, drop_zero_conf)
            return

        from ..core.mesh_io import _PLY_TYPES

        endian = "<" if fmt == "binary_little_endian" else ">"
        names = [p[1] for p in vertex["props"]]
        dtype = np.dtype([(p[1], endian + _PLY_TYPES[p[0]])
                          for p in vertex["props"]])
        remaining = vertex["count"]
        while remaining > 0:
            want = min(remaining, chunk_size)
            arr = np.fromfile(f, dtype=dtype, count=want)
            if len(arr) == 0:
                break
            remaining -= len(arr)
            cols = {"pos": np.stack([arr["x"], arr["y"], arr["z"]],
                                    axis=1).astype(np.float64)}
            if "nx" in names:
                cols["normal"] = np.stack(
                    [arr["nx"], arr["ny"], arr["nz"]], axis=1
                ).astype(np.float64)
            else:
                raise ValueError("Vertex normals missing!")
            scale_name = ("value" if "value" in names
                          else "scale" if "scale" in names else None)
            if scale_name is None:
                raise ValueError("Vertex scale missing!")
            cols["scale"] = arr[scale_name].astype(np.float64)
            if "confidence" in names:
                cols["confidence"] = arr["confidence"].astype(np.float32)
            if "red" in names:
                rgb = np.stack([arr["red"], arr["green"], arr["blue"]],
                               axis=1).astype(np.float32)
                if dtype["red"].kind == "u" or rgb.max(initial=0.0) > 1.0:
                    rgb /= 255.0
                cols["color"] = rgb
            yield _clean_chunk(cols, scale_factor, drop_zero_conf)


def load_samples_from_ply(path: str, scale_factor: float = 1.0) -> SampleList:
    return merge_samples(list(stream_samples_from_ply(path, scale_factor)))


def ply_vertex_count(path: str) -> int:
    """Vertex count from the PLY header only (no payload read) — used to
    decide whether to engage the memory-bounded streaming path."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"ply"):
            raise IOError(f"{path}: not a PLY file")
        while True:
            line = f.readline()
            if not line:
                raise IOError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if parts[:1] == ["end_header"]:
                return 0
            if parts[:2] == ["element", "vertex"]:
                return int(parts[2])


def merge_samples(lists) -> SampleList:
    lists = [s for s in lists if len(s)]
    if not lists:
        return SampleList(*(np.zeros((0, 3), np.float32),) * 3,
                          np.zeros(0, np.float32), np.zeros(0, np.float32))
    return SampleList(
        pos=np.concatenate([s.pos for s in lists]),
        normal=np.concatenate([s.normal for s in lists]),
        color=np.concatenate([s.color for s in lists]),
        scale=np.concatenate([s.scale for s in lists]),
        confidence=np.concatenate([s.confidence for s in lists]),
    )
