"""BigGAN's self-attention product: ``softmax(q kᵀ) v`` with no 1/√d scale.

BigGAN's attention block (``models/biggan.py``; Brock et al.,
arXiv:1809.11096, as BigGAN-PyTorch's ``layers.Attention`` builds it)
compares each of a map's L = H·W positions (θ, d = C/8 wide) with the M =
L/4 positions of its 2×2 max-pooled map (φ, d wide) and takes the softmax's
mix of the pooled values (g, C/2 wide): q and k are 24 wide and v 96 at
BigGAN-128's 64² map (C = 192), and the scores are raw dot products, with
no 1/√d. At 64² a score matrix is 4096 × 1024 an image, 4.3 GB in f32 for
a batch of 256, so the card's route never materializes it.

Routes, by the device of q:

- the card: ``torch.nn.functional.scaled_dot_product_attention`` with
  ``scale=1.0``, held to its cuDNN backend (``SDPBackend.CUDNN_ATTENTION``,
  the fused Hopper kernel named ``…_native_sdpa_sm90_flash_fprop…``). It
  takes q and k of another width than v as they are, and on an H100 at
  BigGAN-128's bs256 it was the fastest of the fused backends: 0.88 ms,
  against 1.57 ms for the flash backend, which needs one width for all
  three (q and k zero-padded to 96, four times the score product), and
  2.77 ms for the memory-efficient one. Holding one backend keeps the
  route, and so the kernels the benchmark's reader and the GPU tests name,
  from changing with the library's heuristics. A shape it refuses raises;
  nothing falls back.
- the CPU: ``attention_plain``, the scores materialized in f32, their
  softmax, the product with v, cast back to q's dtype: the tests' route and
  the reference the card's route is held to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ROUTE_KERNELS = ("native_sdpa",)  # the card route's kernels, as the profiler names them


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (N, L, d), k (N, M, d), v (N, M, dv) → softmax over M of q kᵀ, times
    v: (N, L, dv) in q's dtype, computed in f32 with the scores whole."""
    scores = torch.bmm(q.float(), k.float().transpose(1, 2))
    return torch.bmm(torch.softmax(scores, dim=-1), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attention_plain``'s function on either route (module docstring):
    q (N, L, d), k (N, M, d), v (N, M, dv), each with unit stride on its
    last axis → (N, L, dv)."""
    if q.device.type != "cuda":
        return attention_plain(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
        out = F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=1.0)
    return out[:, 0]
