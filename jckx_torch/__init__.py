"""jckx_torch — the PyTorch/CUDA port of jckx for NVIDIA Hopper (H100).

The JAX package ``jckx`` is the reference; this package imports ``torch``,
``numpy`` and the standard library only, never ``jax`` or ``jckx``.
Each Pallas TPU kernel of ``jckx`` on a ported path becomes a CUDA C++
kernel written by hand for ``sm_90a`` (``kernels/csrc``), built with
``nvcc`` at first use and bound through ``ctypes``.

Ported so far: DCGAN and CGAN serving (``python -m jckx_torch.serve``)
through the fused BatchNorm + activation kernel, DCGAN and CGAN training
(``python -m jckx_torch train``) and checkpoint scoring
(``python -m jckx_torch evaluate``).
"""
