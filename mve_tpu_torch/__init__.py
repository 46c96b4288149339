"""mve_tpu_torch — the PyTorch/CUDA port of mve_tpu for NVIDIA Hopper.

The package mirrors mve_tpu's layout so each module's counterpart is easy
to find (core/, sfm/, sfm/bundler/, mvs/, fssr/, render/, math/,
parallel/, ops/, native/, apps/, utils/). Plain tensor code is PyTorch;
the hand-written kernels are the fused descriptor top-2 search in
csrc/top2.cu, a split pre-pass and a tensor-core product (bound in
ops/top2.py); native/ holds mve_tpu's C++ host library, built with g++.

Nothing here imports jax or mve_tpu. Entry points take ``device=`` and
default to ``"cuda"``; they raise when CUDA is absent unless the caller
asks for ``device="cpu"`` (see resolve_device).
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and the scale-space blurs need full float32. PyTorch runs a
# float32 matmul in full precision by default, but a float32 convolution
# goes through cuDNN in TF32 unless told otherwise — SIFT's blurs would
# drift. This mirrors mve_tpu's jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point runs on: what the caller asked for.

    A CUDA device without CUDA raises; there is no silent move to the CPU.
    """
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
