"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  A CUDA device that is not there raises: an
    entry point never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def fp32_matmuls() -> None:
    """Keep the card's fp32 products in fp32: TF32 (10-bit mantissas) off
    for matmuls and cuDNN.  The fine-tune and reaction paths set it before
    they train or evaluate, so that their numbers are the JAX package's fp32
    numbers, not TF32 approximations of them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def check_on(module: torch.nn.Module, device: torch.device,
             what: Optional[str] = None) -> None:
    """Raise unless ``module``'s weights live on ``device``."""
    have = module_device(module)
    if have.type != device.type or (
            device.index is not None and have.index != device.index):
        raise ValueError(f"{what or type(module).__name__} is on {have}, "
                         f"the call asked for {device}")
