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

Over a mesh's model axis (``mesh``, ``parallel/``) the state is laid out
as jckx lays it:

- ``tp``: G and D keep their slices of the leaves that
  ``tp_state_sharding``'s rule shards (``parallel/tp.shard_module``)
  before the optimizers are built, so Adam's moments and the EMA mirror
  their parameters;
- ``spatial``: every leaf is replicated. With ``--spatial_replicate_grads
  0`` each net's optimizer is a ``ShardedAdam``: the flat gradient is
  reduce-scattered over the model axis, Adam updates this member's 1/M
  slice of the flat parameters and moments, and the parameters are
  all-gathered back, the other layout jckx lets XLA pick
  (``jckx/train/gan_trainer.py:212-237``). Adam is elementwise, so the
  numbers are those of the replicated update up to the order of the
  gradient's sums.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from jckx_torch.configs import Config
from jckx_torch.models.cgan import CDiscriminator
from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
from jckx_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from jckx_torch.parallel.tp import shard_module


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
    # the process mesh of a multi-rank run (checkpoints gather over it)
    mesh: Any = None


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


class ShardedAdam:
    """``make_optimizer``'s Adam on this member's 1/M slice of a net's flat
    parameters (``--model_axis_mode spatial --spatial_replicate_grads 0``).
    It reduces its own gradients (``reduces_grads``): ``step`` reduce-
    scatters the flat gradient over the model axis, sums its slice over the
    data axis, divides by D·M (``ProcessMesh.average_grads``' mean), takes
    the Adam step on the slice and all-gathers the parameters.
    ``state_dict`` / ``load_state_dict`` speak torch Adam's per-parameter
    format with full tensors (every member must call them)."""

    reduces_grads = True

    def __init__(self, cfg: Config, params, mesh):
        self.params = list(params)
        self.mesh = mesh
        self.numel = sum(p.numel() for p in self.params)
        self.chunk = -(-self.numel // mesh.model_size)
        self.master = torch.nn.Parameter(self._mine(self._flat([p.detach() for p in self.params])))
        self.inner = make_optimizer(cfg, [self.master])

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def _flat(self, tensors) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.chunk * self.mesh.model_size - self.numel))

    def _mine(self, flat: torch.Tensor) -> torch.Tensor:
        i = self.mesh.model_rank
        return flat[i * self.chunk:(i + 1) * self.chunk].clone()

    def _full(self, mine: torch.Tensor) -> list:
        """This member's slice → every parameter's full tensor."""
        flat = self.mesh.all_gather(mine.detach(), 0, MODEL_AXIS)[:self.numel]
        return list(flat.split([p.numel() for p in self.params]))

    def sync_params(self) -> None:
        """Take the slice from the parameters again (after a restore)."""
        with torch.no_grad():
            self.master.copy_(self._mine(self._flat([p.detach() for p in self.params])))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        g = self._flat([p.grad if p.grad is not None else torch.zeros_like(p)
                        for p in self.params])
        g = self.mesh.reduce_scatter(g, 0, MODEL_AXIS)
        g = self.mesh.all_reduce(g, DATA_AXIS) / (self.mesh.size * self.mesh.model_size)
        self.master.grad = g
        self.inner.step()
        with torch.no_grad():
            for p, v in zip(self.params, self._full(self.master)):
                p.copy_(v.view_as(p))

    def state_dict(self) -> dict:
        group = {k: v for k, v in self.inner.param_groups[0].items() if k != "params"}
        out = {"state": {}, "param_groups": [{**group, "params": list(range(len(self.params)))}]}
        st = self.inner.state.get(self.master)
        if st:
            moments = {k: self._full(st[k]) for k in ("exp_avg", "exp_avg_sq")}
            for i, p in enumerate(self.params):
                out["state"][i] = {"step": st["step"].clone(),
                                   **{k: v[i].view_as(p).clone() for k, v in moments.items()}}
        return out

    def load_state_dict(self, sd: dict) -> None:
        for k, v in sd["param_groups"][0].items():
            if k != "params":
                self.inner.param_groups[0][k] = v
        self.sync_params()
        if not sd.get("state"):
            return
        per = [sd["state"][i] for i in range(len(self.params))]
        self.inner.state[self.master] = {
            "step": torch.as_tensor(per[0]["step"], dtype=torch.float32).clone(),
            **{k: self._mine(self._flat([s[k] for s in per])).to(self.master.device)
               for k in ("exp_avg", "exp_avg_sq")}}


def _model_axis(cfg: Config, mesh) -> Optional[str]:
    return cfg.model_axis_mode if mesh is not None and mesh.model_size > 1 else None


def create_dcgan_state(cfg: Config, G: Generator, D: Discriminator, mesh=None) -> GANTrainState:
    """A fresh state around G and D (already on their device), laid out
    over ``mesh``'s model axis (module docstring)."""
    mode = _model_axis(cfg, mesh)
    if mode == "tp":
        shard_module(G, mesh, cfg.tp_min_dim, transposed=True)
        shard_module(D, mesh, cfg.tp_min_dim, transposed=False)

    def optimizer(net):
        if mode == "spatial" and not cfg.spatial_replicate_grads:
            return ShardedAdam(cfg, net.parameters(), mesh)
        return make_optimizer(cfg, net.parameters())

    return GANTrainState(
        G=G, D=D, opt_g=optimizer(G), opt_d=optimizer(D), step=0, seed=cfg.seed,
        ema_g=ema_copy(G) if cfg.ema_decay > 0 else None, mesh=mesh,
    )


# A fresh CGAN state is the same record around the conditional nets (D's
# Adam state in D's registration order, label path first).
create_cgan_state = create_dcgan_state
