"""The benchmark of jckx_torch, the PyTorch/CUDA port of jckx (see README.md)."""
