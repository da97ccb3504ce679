"""repro_torch — the PyTorch/CUDA port of ``repro``.

Laid out with ``repro``'s subpackages and public names, so each module's
counterpart is easy to find.  The JAX package stays the reference: the
``tests/test_torch_*.py`` files hold every ported module against it.

The port imports ``torch`` and numpy and never ``jax`` or ``repro``; what
it needs of ``repro``'s numpy-only packages it keeps as its own copy
(``runtime``, ``core``, ``topology``, ``trace``, ``obs``, ``check``,
``control``, ``spec``), so traces, specs and lint reports pass between the
two packages as files.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise instead of quietly
running on the CPU.  The hand-written Hopper kernels live in ``csrc/`` and
are built by ``nvcc`` at first use (``repro_torch.kernels._build``).
"""
