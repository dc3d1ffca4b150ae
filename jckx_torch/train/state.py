"""Training state — port of ``jckx/train/state.py``.

jckx keeps both adversaries in one immutable pytree that the jitted step
maps to a new one. Here the state is a small mutable record: the two
modules, two ``torch.optim.Adam(betas=(0.5, 0.999), eps=1e-8)`` (the
update rule of ``optax.adam``, pinned at 1e-6 by
``tests/test_step_torch_parity.py``), the step, the run seed (the step's
random draws derive from (seed, step), so a restored state continues
exactly), and an optional EMA copy of G. The train step updates it in
place.

Parameters and Adam moments stay f32; the models cast weights to the
compute dtype inside their forward.

``lr_schedule="cosine"`` scales each update by the cosine factor at the
optimizer's own step count, as jckx's ``make_optimizer`` (``:73-86``) does,
by setting the group's lr to ``max_lr · factor(count)`` before the step.
The count lives in the optimizer's state, so a resumed run continues its
decay and the state dict is the same as under the constant schedule.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from jckx_torch.configs import Config
from jckx_torch.models.cgan import CDiscriminator
from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator


@dataclass
class GANTrainState:
    G: Generator  # or its subclass, CGAN's CGenerator
    D: Union[Discriminator, CDiscriminator]
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int
    seed: int
    # EMA of G's weights (Config.ema_decay > 0); eval samples from it
    ema_g: Optional[Generator] = None


def geometry(cfg: Config) -> GANGeometry:
    return GANGeometry(z_dim=cfg.z_dim, image_size=cfg.image_size,
                       channels=cfg.channels, base_width=cfg.base_width)


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    if cfg.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r}: expected 'constant' or 'cosine'")
    if cfg.lr_schedule == "cosine":
        if cfg.max_learning_rate <= 0:
            raise ValueError("lr_schedule=cosine needs max_learning_rate > 0")
        if cfg.lr_decay_steps <= 0:
            raise ValueError("lr_schedule=cosine needs lr_decay_steps > 0 (the trainer "
                             "fills it with epochs x steps_per_epoch)")
    return torch.optim.Adam(params, lr=cfg.max_learning_rate,
                            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=1e-8)


def adam_count(opt: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken (0 before the first)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


def cosine_factor(cfg: Config, count: int) -> float:
    """``optax.cosine_decay_schedule(1.0, lr_decay_steps, alpha=min/max)`` at ``count``."""
    total = cfg.lr_decay_steps
    alpha = cfg.min_learning_rate / cfg.max_learning_rate
    cos = 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))
    return (1.0 - alpha) * cos + alpha


def adam_step(opt: torch.optim.Adam, cfg: Config) -> None:
    """One update, under the configured schedule."""
    if cfg.lr_schedule == "cosine":
        lr = cfg.max_learning_rate * cosine_factor(cfg, adam_count(opt))
        for group in opt.param_groups:
            group["lr"] = lr
    opt.step()


def ema_copy(G: Generator) -> Generator:
    return copy.deepcopy(G).requires_grad_(False)


def create_dcgan_state(cfg: Config, G: Generator, D: Discriminator) -> GANTrainState:
    """A fresh state around G and D (already on their device)."""
    return GANTrainState(
        G=G, D=D,
        opt_g=make_optimizer(cfg, G.parameters()),
        opt_d=make_optimizer(cfg, D.parameters()),
        step=0, seed=cfg.seed,
        ema_g=ema_copy(G) if cfg.ema_decay > 0 else None,
    )


# A fresh CGAN state is the same record around the conditional nets (D's
# Adam state in D's registration order, label path first).
create_cgan_state = create_dcgan_state
