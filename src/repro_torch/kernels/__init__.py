"""Hand-written Hopper kernels of the port, one subpackage per family.

Each family keeps ``ref.py`` (the plain PyTorch version), the kernel's
wrapper, and ``ops.py`` (the public entry points that dispatch a CUDA
tensor to the kernel and a CPU tensor to the plain version).  The CUDA
sources live in ``repro_torch/csrc`` and are built by ``_build``.
"""
