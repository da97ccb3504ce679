"""Device selection for the port's entry points, and the one test of
whether a tensor takes the hand-written kernels' path."""
from __future__ import annotations

import torch


def kernel_path(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels' path: a CUDA tensor launches the
    kernel; a ``meta`` tensor (the dry run, the counted steps) walks the
    same path, allocating and reporting what the launch would, and
    launches nothing.  A CPU tensor takes the plain version."""
    return x.device.type in ("cuda", "meta")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for and there is no card — the port
    never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
