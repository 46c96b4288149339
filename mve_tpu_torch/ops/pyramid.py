"""Wrapper of the CUDA level-image kernels (csrc/pyramid.cu).

They replace no TPU kernel: mve_tpu builds MVS level images in numpy on
the host, and that numpy path (mvs/pyramid.half_size_gaussian_np applied
`level` times to mvs/pyramid._to_gray) is the plain version, run by
mvs/pyramid.ImagePyramidCache for a CPU device. A CUDA tensor launches the
kernels or raises. `launches` counts kernel launches, so a run can show
that its level images went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0

_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def _lib():
    lib = cuda_build.load("pyramid")
    if lib.pyramid_half_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pyramid_gray_launch.argtypes = [P, I, I, I, I, P, P]
        lib.pyramid_gray_launch.restype = I
        lib.pyramid_half_launch.argtypes = [P, I, I, I, I, F, F, F, F, P, P]
        lib.pyramid_half_launch.restype = I
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def level_image(image: torch.Tensor, level: int, taps) -> torch.Tensor:
    """The gray plane of image (H, W, C), halved `level` times.

    image: a contiguous CUDA tensor of uint8, uint16 or float32, C >= 1.
    taps: the four float32 taps of a halving (mvs/pyramid.half_size_taps).
    Returns a float32 CUDA tensor of the level's (H, W), bit-identical to
    the numpy path. Launches max(level, 1) kernels on the current stream:
    the gray step is fused into the first halving; the intermediate
    levels are freed on return.
    """
    global launches
    if not image.is_cuda:
        raise ValueError(f"image: the level kernels run on CUDA tensors only, got {image.device}")
    if image.dtype not in _DTYPES:
        raise TypeError(f"image: expected one of {sorted(map(str, _DTYPES))}, got {image.dtype}")
    if image.dim() != 3 or min(image.shape) < 1:
        raise ValueError(f"image: expected a non-empty (H, W, C) tensor, got {tuple(image.shape)}")
    if not image.is_contiguous():
        raise ValueError("image: expected a contiguous tensor")
    if level < 0:
        raise ValueError(f"level must be >= 0, got {level}")
    taps = [float(t) for t in taps]
    if len(taps) != 4:
        raise ValueError(f"expected 4 taps, got {len(taps)}")
    lib = _lib()
    h, w, c = image.shape
    src, dtype = image, _DTYPES[image.dtype]
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        if level == 0:
            out = torch.empty((h, w), dtype=torch.float32, device=image.device)
            _check(lib.pyramid_gray_launch(src.data_ptr(), dtype, h, w, c, out.data_ptr(), stream),
                   "pyramid gray kernel")
            launches += 1
            return out
        for _ in range(level):
            out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                              device=image.device)
            _check(lib.pyramid_half_launch(src.data_ptr(), dtype, h, w, c, *taps,
                                           out.data_ptr(), stream), "pyramid halving kernel")
            launches += 1
            # The previous level's memory goes back to the caching
            # allocator, which reuses it only after this launch on the
            # same stream.
            src, dtype, c, (h, w) = out, _DTYPES[torch.float32], 1, out.shape
    return out
