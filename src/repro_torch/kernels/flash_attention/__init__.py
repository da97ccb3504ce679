"""The flash attention family: ``ref`` (plain PyTorch), ``kernel`` (K3) and
``ops`` (entry point)."""
