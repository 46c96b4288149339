"""Builds the hand-written CUDA kernels in mve_tpu_torch/csrc/ at first use.

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes. The library name carries a hash of
the source and flags, so an edited source never loads a stale build. The
build directory is build/mve_tpu_torch/ at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mve_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _cuda_tool(tool: str) -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", tool),
                 shutil.which(tool)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{tool} not found (set CUDA_HOME or put {tool} on PATH)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str], force: bool = False) -> Dict[str, str]:
    """Compile every named source that has no current library (every one
    with force), one nvcc process per source, all started together.
    Returns each build's compiler output (ptxas register, shared-memory
    and spill report); raises with the compiler's output if any build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file() and not force:
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def sass(name: str) -> str:
    """The machine code of csrc/<name>.cu's library, as cuobjdump -sass
    prints it (built first if needed)."""
    load(name)
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
