"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

#: floating dtypes the kernels are instantiated for, with their C suffixes
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def check_cuda_args(name, dtype, device, **tensors):
    """Raise unless every tensor lies on ``device``, is contiguous, and has
    the dtype and shape given with it.  ``tensors`` maps a name to
    ``(tensor, expected_shape)`` or ``(tensor, expected_shape, dtype)``;
    without a dtype it is ``dtype``, or int32 when the name starts with
    ``i_``."""
    if device.type != "cuda":
        raise ValueError(
            f"{name}: the kernel runs on CUDA tensors, got device {device}; "
            "CPU tensors take the plain PyTorch version."
        )
    if dtype not in SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} is not float32 or float64.")
    index = device.index
    for arg, (x, shape, *want) in tensors.items():
        want = want[0] if want else (
            torch.int32 if arg.startswith("i_") else dtype)
        # the common case in one test: wrappers run once per kernel launch
        if (x.dtype == want and x.shape == shape and x.is_contiguous()
                and x.is_cuda and x.get_device() == index):
            continue
        if x.device != device:
            raise ValueError(f"{name}: {arg} is on {x.device}, not {device}.")
        if x.dtype != want:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, not {want}.")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name}: {arg} has shape {tuple(x.shape)}, expected "
                f"{tuple(shape)}."
            )
        raise ValueError(f"{name}: {arg} must be contiguous.")
