"""The device on which an entry point makes new tensors."""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` when given, else the CUDA card.

    The port's entry points run on the card unless the caller asks for the
    CPU (``device="cpu"``, as the tests do). Without a card the default
    raises: nothing falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points default to the card; "
            "pass device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda")


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor. A tensor stays on its device unless
    ``device`` is given; anything else goes to ``default_device(device)``,
    the CUDA card by default."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=default_device(device))
