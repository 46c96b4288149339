"""ctypes bindings of the port's native host kernels (mve_native.cpp in
this directory, a copy of mve_tpu's native/mve_native.cpp; port of
mve_tpu/native/__init__.py).

The shared library is built with g++ at first use into
build/mve_tpu_torch/ at the root of the checkout, never into the package
directory; its name carries a hash of the source and flags, so an edited
source is rebuilt. Every binding returns None where the library cannot be
built or loaded (no compiler), and each caller then takes its Python
fallback, which gives the same result.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mve_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mve_tpu_torch"
# mve_tpu's Makefile adds -march=native. Without it the library runs on any
# x86-64 host it is copied to, and with floating-point contraction off no
# a*b+c is fused, so the distance tests round as the numpy fallbacks do.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-ffp-contract=off")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmve_native-{digest[:12]}.so"


def build(force: bool = False) -> str:
    """Compile the library unless it is built (always with force); returns
    the compiler's output. Raises RuntimeError if there is no compiler or
    the build fails. The library appears under its final name only once
    complete, so concurrent builders never load a partial file."""
    out = library_path()
    if out.is_file() and not force:
        return ""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def get_lib():
    """The loaded library (built first if needed); None if unavailable."""
    try:
        build()
        lib = ctypes.CDLL(str(library_path()))
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    I64, I32, I8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_int8
    P = ctypes.POINTER
    lib.mesh_classify_vertices.argtypes = [I64, I64, P(I32), P(I8)]
    lib.mesh_classify_vertices.restype = None
    lib.mesh_components.argtypes = [I64, I64, P(I32), P(I64)]
    lib.mesh_components.restype = None
    lib.mesh_collapse_edges.argtypes = [I64, I64, P(I64), P(ctypes.c_float), P(I64)]
    lib.mesh_collapse_edges.restype = I64
    lib.mesh_boundary_confidences.argtypes = [I64, I64, P(I32), P(I8), I32, P(ctypes.c_float)]
    lib.mesh_boundary_confidences.restype = None
    D = P(ctypes.c_double)
    lib.fssr_influence_pairs.argtypes = [I64, D, I64, D, D, P(I64), P(I64), I64]
    lib.fssr_influence_pairs.restype = I64
    lib.fssr_scale_filter.argtypes = [I64, P(I64), P(I64), D, I64]
    lib.fssr_scale_filter.restype = I64
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _faces32(faces, n_verts):
    """Faces as contiguous (F, 3) int32, checked against the vertex count
    before native code indexes with them."""
    faces = np.ascontiguousarray(np.asarray(faces).reshape(-1, 3), np.int32)
    if len(faces) and (faces.min() < 0 or faces.max() >= n_verts):
        raise ValueError("face index out of range")
    return faces


def classify_vertices(n_verts: int, faces: np.ndarray):
    """(n_verts,) int8 vertex classes, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    faces = _faces32(faces, n_verts)
    out = np.empty(n_verts, np.int8)
    lib.mesh_classify_vertices(n_verts, len(faces), _ptr(faces, ctypes.c_int32),
                               _ptr(out, ctypes.c_int8))
    return out


def components(n_verts: int, faces: np.ndarray):
    """(n_verts,) int64 component root per vertex, or None."""
    lib = get_lib()
    if lib is None:
        return None
    faces = _faces32(faces, n_verts)
    out = np.empty(n_verts, np.int64)
    lib.mesh_components(n_verts, len(faces), _ptr(faces, ctypes.c_int32),
                        _ptr(out, ctypes.c_int64))
    return out


def collapse_edges(vertices: np.ndarray, edges: np.ndarray):
    """(count, target_map, new float32 vertices) of collapsing each edge's
    second vertex into its first, or None."""
    lib = get_lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(vertices, np.float32).copy()
    edges = np.ascontiguousarray(np.asarray(edges).reshape(-1, 2), np.int64)
    if len(edges) and (edges.min() < 0 or edges.max() >= len(verts)):
        raise ValueError("edge index out of range")
    target = np.empty(len(verts), np.int64)
    count = lib.mesh_collapse_edges(len(verts), len(edges), _ptr(edges, ctypes.c_int64),
                                    _ptr(verts, ctypes.c_float), _ptr(target, ctypes.c_int64))
    return int(count), target, verts


def fssr_influence_pairs(voxel_pos: np.ndarray, sample_pos: np.ndarray,
                         sample_scale: np.ndarray):
    """(pair_v, pair_s) int64 of every (voxel, sample) with |v - p| <
    3 x scale, in the native order (by scale octave, voxel, neighbour
    cell), or None."""
    lib = get_lib()
    if lib is None:
        return None
    vox = np.ascontiguousarray(voxel_pos, np.float64).reshape(-1, 3)
    pos = np.ascontiguousarray(sample_pos, np.float64).reshape(-1, 3)
    scale = np.ascontiguousarray(sample_scale, np.float64).reshape(-1)
    if len(scale) != len(pos):
        raise ValueError("one scale per sample")
    D, I = ctypes.c_double, ctypes.c_int64
    n = lib.fssr_influence_pairs(len(vox), _ptr(vox, D), len(pos), _ptr(pos, D),
                                 _ptr(scale, D), None, None, 0)
    out_v = np.empty(n, np.int64)
    out_s = np.empty(n, np.int64)
    n2 = lib.fssr_influence_pairs(len(vox), _ptr(vox, D), len(pos), _ptr(pos, D),
                                  _ptr(scale, D), _ptr(out_v, I), _ptr(out_s, I), n)
    if n2 != n:
        return None
    return out_v, out_s


def fssr_scale_filter(pair_v: np.ndarray, pair_s: np.ndarray,
                      sample_scale: np.ndarray, n_voxels: int):
    """The pairs that the per-voxel scale filter keeps (grouped by voxel,
    in their given order within a voxel), or None."""
    lib = get_lib()
    if lib is None:
        return None
    pv = np.ascontiguousarray(pair_v, np.int64).copy()
    ps = np.ascontiguousarray(pair_s, np.int64).copy()
    scale = np.ascontiguousarray(sample_scale, np.float64)
    if len(pv) != len(ps) or (len(pv) and (
            pv.min() < 0 or pv.max() >= n_voxels or ps.min() < 0 or ps.max() >= len(scale))):
        raise ValueError("pair index out of range")
    kept = lib.fssr_scale_filter(len(pv), _ptr(pv, ctypes.c_int64), _ptr(ps, ctypes.c_int64),
                                 _ptr(scale, ctypes.c_double), n_voxels)
    return pv[:kept], ps[:kept]


def boundary_confidences(n_verts: int, faces: np.ndarray, vclass: np.ndarray,
                         iterations: int):
    """(n_verts,) float32 confidences ramping from 0 at the border over
    `iterations` rings, or None."""
    lib = get_lib()
    if lib is None:
        return None
    faces = _faces32(faces, n_verts)
    vclass = np.ascontiguousarray(vclass, np.int8)
    if len(vclass) != n_verts:
        raise ValueError("one class per vertex")
    confs = np.ones(n_verts, np.float32)
    lib.mesh_boundary_confidences(n_verts, len(faces), _ptr(faces, ctypes.c_int32),
                                  _ptr(vclass, ctypes.c_int8), iterations,
                                  _ptr(confs, ctypes.c_float))
    return confs
