"""Frozen copies of the rules by which the program turns its inputs into
the numbers it works on. The reference needs them to work those numbers
out again, and a copy here cannot change when the program does.

- ``derive_seed``: a step's or an eval's generator seed from (seed, tag,
  count) (``jckx_torch/train/steps.py`` ``derive_seed``);
- ``request_seed``: a served request's generator seed from (seed, count)
  (``jckx_torch/serve.py`` ``_request_seed``);
- ``step_draws``: a train step's random inputs, drawn in the program's
  order from the generator of (seed, step) (``steps.make_draws``);
- ``epoch_order``: an epoch's batches of row indices
  (``gan_trainer.train``: ``np.random.RandomState(seed).permutation``);
- ``decode``: uint8 rows to images in [-1, 1] at the train size
  (``data/pipeline.decode_batch``, bilinear as ``jax.image.resize``);
- ``to_u8``: a render in [-1, 1] to uint8 (``serve.tanh_to_u8``, floor);
- ``request_latents``: the z (and CGAN labels) of each 512-row batch of a
  served request (``GeneratorService.sample``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HIDDEN = 256          # CGAN D's linear1 width: its dropout masks are (N, 256)
KEEP = 0.75           # 1 - CGAN D's dropout rate


def derive_seed(seed: int, tag: str, count: int) -> int:
    digest = hashlib.sha256(f"{seed}:{tag}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def request_seed(seed: int, count: int) -> int:
    digest = hashlib.sha256(f"{seed}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def step_draws(seed: int, step: int, n: int, size: int, channels: int, z_dim: int,
               device, conditional: bool) -> Dict[str, torch.Tensor]:
    """One step's draws: real noise and fake noise (N, S, S, C), z (N,
    z_dim), alpha (N, 1, 1, 1); CGAN's four dropout keep-masks (N, 256)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "step", step))
    shape = (n, size, size, channels)
    out = {"real_noise": torch.randn(shape, generator=gen, device=device),
           "z": torch.randn((n, z_dim), generator=gen, device=device),
           "fake_noise": torch.randn(shape, generator=gen, device=device),
           "alpha": torch.rand((n, 1, 1, 1), generator=gen, device=device)}
    if conditional:
        for name in ("keep_real", "keep_fake", "keep_gp", "keep_g"):
            out[name] = (torch.rand((n, HIDDEN), generator=gen, device=device) < KEEP).float()
    return out


def epoch_order(seed: int, rows: int, batch: int) -> np.ndarray:
    """The first epoch's batches of row indices, (steps per epoch, batch)."""
    steps = rows // batch
    return np.random.RandomState(seed).permutation(rows)[:steps * batch].reshape(steps, batch)


def decode(u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 NHWC → f32 NHWC in [-1, 1] at ``size``."""
    x = u8.float() / 255.0
    if x.shape[1] != size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                          align_corners=False, antialias=size < x.shape[1]).permute(0, 2, 3, 1)
    return (x - 0.5) / 0.5


def to_u8(images: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(images.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


def request_latents(seed: int, n: int, batch: int, z_dim: int, device,
                    labels: Optional[Sequence[int]] = None
                    ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor], int]]:
    """A request of ``n`` images with its own ``seed`` → for each batch
    (z (batch, z_dim), class ids (batch,) or None, the rows it delivers).
    With ``labels`` row i of the request takes labels[i % len(labels)]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(request_seed(seed, 0))
    lab = None if labels is None else torch.as_tensor(np.asarray(labels, np.int64), device=device)
    rows = torch.arange(batch, device=device)
    out, made = [], 0
    while made < n:
        z = torch.randn((batch, z_dim), generator=gen, device=device)
        ids = None if lab is None else lab[(made + rows) % lab.numel()]
        take = min(batch, n - made)
        out.append((z, ids, take))
        made += take
    return out
