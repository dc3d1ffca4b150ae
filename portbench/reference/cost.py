"""The yardstick's arithmetic: the operations of one train step and of one
generator forward, counted by ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference on the meta device (no memory, no device), and
the bytes the fused BN + activation kernel must move per generator
forward. The program's own counts (``jckx_torch/utils/cost.py``) are not
used: a change to the program must not move its yardstick.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import gan

META = torch.device("meta")


def meta_params(shapes: dict) -> dict:
    return {k: torch.empty(tuple(s), device=META) for k, s in shapes.items()}


def _meta_draws(cfg: dict, n: int) -> dict:
    s, c = cfg["image_size"], cfg["channels"]
    draws = {"real_noise": torch.empty((n, s, s, c), device=META),
             "z": torch.empty((n, cfg["z_dim"]), device=META),
             "fake_noise": torch.empty((n, s, s, c), device=META),
             "alpha": torch.empty((n, 1, 1, 1), device=META)}
    if cfg["conditional"]:
        for name in ("keep_real", "keep_fake", "keep_gp", "keep_g"):
            draws[name] = torch.empty((n, 256), device=META)
    return draws


def _onehot(cfg: dict, n: int) -> Optional[torch.Tensor]:
    return torch.empty((n, cfg["num_classes"]), device=META) if cfg["conditional"] else None


def step_flops(cfg: dict, batch: int) -> int:
    """Operations of one train step at ``batch``: G's forward, D's three
    passes and their backward, the penalty's double backward, G's pass
    through D and its backward (the optimizers' elementwise work is not
    counted, as no FLOP counter counts it)."""
    shapes = gan.param_shapes(cfg)
    g = {k: v.requires_grad_(True) for k, v in meta_params(shapes["g"]).items()}
    d = {k: v.requires_grad_(True) for k, v in meta_params(shapes["d"]).items()}
    s, c = cfg["image_size"], cfg["channels"]
    real, draws, onehot = torch.empty((batch, s, s, c), device=META), _meta_draws(cfg, batch), \
        _onehot(cfg, batch)
    with FlopCounterMode(display=False) as counter:
        loss_d, fake, fake_noise, _ = gan.losses(g, d, cfg, real, draws, onehot)
        torch.autograd.grad(loss_d, list(d.values()))
        loss_g = gan.g_loss(fake, fake_noise, d, cfg, draws, onehot)
        torch.autograd.grad(loss_g, list(g.values()))
    return int(counter.get_total_flops())


def forward_flops(cfg: dict, batch: int) -> int:
    """Operations of one generator forward of ``batch`` images."""
    g = meta_params(gan.param_shapes(cfg)["g"])
    with FlopCounterMode(display=False) as counter:
        gan.generator(g, cfg, torch.empty((batch, cfg["z_dim"]), device=META),
                      _onehot(cfg, batch))
    return int(counter.get_total_flops())


def bn_act_bytes(cfg: dict, batch: int, element_bytes: int) -> int:
    """Bytes the BN + activation kernel must move in one generator forward
    of ``batch`` images: each BN layer's input read once and its output
    written once (``element_bytes`` each), and its two per-channel f32
    vectors (scale, shift) read once."""
    total, side = 0, 4
    for w in gan.stage_widths(cfg):
        total += 2 * batch * side * side * w * element_bytes + 2 * w * 4
        side *= 2
    return total
