"""Hand-written Hopper kernels of the port, one subpackage per family.

Each family keeps ``ref.py`` (the plain PyTorch version), the kernel's
wrapper, and ``ops.py`` (the public entry points that dispatch a CUDA
tensor to the kernel, a meta tensor to the kernel's path without a launch
(``_device.kernel_path``), and a CPU tensor to the plain version).  The CUDA
sources live in ``repro_torch/csrc`` and are built by ``_build``.
"""
import torch


def refuse_grad(kernel: str, item: str, *xs) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an input in ``xs``
    requires grad.  K1 and K2 (the Jacobi sweeps) call it: neither package
    differentiates the stencil, so they have no backward kernel (ROADMAP
    ``item``), and a result written through ``ctypes`` would carry no
    autograd history, so every gradient through it would be silently
    missing.  K3, K4 and K5 run as ``torch.autograd.Function``s in grad
    mode instead (``FlashAttentionFn``, ``WKV6Fn``, ``RGLRUScanFn``)."""
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in xs):
        raise RuntimeError(
            f"{kernel} has no backward kernel on the card (ROADMAP {item}): run it "
            f"under torch.no_grad() or on inputs that do not require grad, or "
            f"take the plain path (use_kernel=False), which autograd differentiates")
