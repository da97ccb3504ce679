"""The RWKV-6 WKV family: ``ref`` (plain PyTorch), ``kernel`` (K4) and
``ops`` (entry point)."""
