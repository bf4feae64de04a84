"""Shared helpers of the example scripts."""

import torch

from ..state import resolve_device


def example_steps(n, scale):
    """``n`` steps scaled by ``scale`` (a smoke run passes a small
    fraction; 1.0 is the full demonstration run), at least 4."""
    return max(4, int(n * scale))


def device_and_generator(device, seed):
    """The device an example runs on (the GPU unless ``device`` says
    otherwise) and a ``torch.Generator`` there seeded with ``seed``, for the
    start's draws."""
    device = resolve_device(device)
    return device, torch.Generator(device=device).manual_seed(seed)
