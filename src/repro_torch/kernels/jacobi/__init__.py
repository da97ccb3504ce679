"""The Jacobi stencil family: ``ref`` (plain PyTorch), ``kernel`` (K1, one
sweep), ``temporal`` (K2, two sweeps per pass) and ``ops`` (entry points)."""
