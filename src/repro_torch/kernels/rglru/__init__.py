"""The RG-LRU scan family: ``ref`` (plain PyTorch), ``kernel`` (K5) and
``ops`` (entry point)."""
