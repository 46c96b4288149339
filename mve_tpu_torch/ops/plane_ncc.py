"""Wrapper of the slanted-plane NCC kernel (csrc/plane_ncc.cu).

It replaces no TPU kernel: mve_tpu scores slanted patches with plain XLA.
The plain version is mvs/patch._plane_tap_sums_plain, which
mvs/patch._plane_tap_sums runs for a CPU tensor; a CUDA tensor launches
the kernel or raises. `launches` counts kernel launches, and each launch
adds its outputs to the counter `plane_ncc_px` of the innermost open span,
so a run can show that its plane NCCs went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.tracing import count
from . import cuda_build

launches = 0

# The views' operators and sizes sit in a block's shared memory, 14
# float32 a view, within the 48 KB a launch gets without opting in.
MAX_VIEWS = 48 * 1024 // (14 * 4)


def _lib():
    lib = cuda_build.load("plane_ncc")
    if lib.plane_ncc_launch.argtypes is None:
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.plane_ncc_launch.argtypes = [P, P, I, I, P, I, I, I, P, P, P, P, L, L, L, L,
                                         P, P, P, I, I, I, F, P, P, P]
        lib.plane_ncc_launch.restype = I
    return lib


def _check_tensor(name, t, dtype, dim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dimensions, got shape {tuple(t.shape)}")


def plane_ncc(ref, neigh, T, tvec, hw, jidx, ray_z, depths, dzx, dzy, fw: int, inv_n: float):
    """Slanted-plane NCC of every plane of depths/dzx/dzy in the views jidx.

    ref, ray_z: (H, W) float32; neigh: (J, Hn, Wn) float32; T: (J, 3, 3),
    tvec: (J, 3) float32; hw: None, or (J, 2) float32 each view's own
    (height, width) inside (Hn, Wn); jidx: int64 (lead, 1 or K, H or 1,
    W or 1), the view of each output; depths, dzx, dzy: (K, H, W) float32;
    fw: the odd window width; inv_n: the float32 reciprocal of fw * fw.
    All on one CUDA device, contiguous but jidx. Returns (ncc float32,
    valid bool), each (lead, K, H, W), bit-identical to
    mvs/patch._plane_tap_sums_plain. One launch on the current stream.
    """
    global launches
    for name, t, dim in (("ref", ref, 2), ("ray_z", ray_z, 2), ("neigh", neigh, 3),
                         ("T", T, 3), ("tvec", tvec, 2), ("depths", depths, 3),
                         ("dzx", dzx, 3), ("dzy", dzy, 3)):
        _check_tensor(name, t, torch.float32, dim)
    _check_tensor("jidx", jidx, torch.int64, 4)
    K, H, W = depths.shape
    J, Hn, Wn = neigh.shape
    shapes = {"ref": (ref, (H, W)), "ray_z": (ray_z, (H, W)), "T": (T, (J, 3, 3)),
              "tvec": (tvec, (J, 3)), "dzx": (dzx, (K, H, W)), "dzy": (dzy, (K, H, W))}
    if hw is not None:
        _check_tensor("hw", hw, torch.float32, 2)
        shapes["hw"] = (hw, (J, 2))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got {tuple(t.shape)}")
    lead = jidx.shape[0]
    try:
        jx = jidx.expand(lead, K, H, W)
    except RuntimeError:
        raise ValueError(f"jidx: shape {tuple(jidx.shape)} does not broadcast to "
                         f"({lead}, {K}, {H}, {W})") from None
    if min(K, H, W, J, lead, Hn, Wn) < 1:
        raise ValueError("empty input")
    if Hn < 2 or Wn < 2:
        raise ValueError(f"neigh: a view needs two rows and columns, got ({Hn}, {Wn})")
    if fw < 1 or fw % 2 != 1:
        raise ValueError(f"fw must be odd and positive, got {fw}")
    if J > MAX_VIEWS:
        raise ValueError(f"at most {MAX_VIEWS} views, got {J}")
    if K > 65535:
        raise ValueError(f"at most 65535 planes a launch, got {K}")
    dense = [ref, ray_z, neigh, T, tvec, depths, dzx, dzy] + ([] if hw is None else [hw])
    if not all(t.is_contiguous() for t in dense):
        raise ValueError("expected contiguous inputs (all but jidx)")
    for t in dense + [jidx]:
        if not t.is_cuda:
            raise ValueError(f"the plane NCC kernel runs on CUDA tensors only, got {t.device}")
        if t.device != depths.device:
            raise ValueError(f"inputs on {t.device} and {depths.device}")
    lib = _lib()
    ncc = torch.empty((lead, K, H, W), dtype=torch.float32, device=depths.device)
    valid = torch.empty((lead, K, H, W), dtype=torch.bool, device=depths.device)
    with torch.cuda.device(depths.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plane_ncc_launch(
            ref.data_ptr(), ray_z.data_ptr(), H, W, neigh.data_ptr(), J, Hn, Wn,
            T.data_ptr(), tvec.data_ptr(), None if hw is None else hw.data_ptr(),
            jx.data_ptr(), *jx.stride(), depths.data_ptr(), dzx.data_ptr(), dzy.data_ptr(),
            K, lead, fw, inv_n, ncc.data_ptr(), valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"plane NCC kernel launch failed: CUDA error {err}")
    launches += 1
    count("plane_ncc_px", lead * K * H * W)
    return ncc, valid
