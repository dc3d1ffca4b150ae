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
step count, as jckx's ``make_optimizer`` (``:73-86``) does at optax's
count: ``schedule_lr`` sets both groups' lr to ``max_lr · factor(step)``
before the step, from the state's own counter (a restored state carries
it, so a resumed run continues its decay).

On the card both optimizers are ``capturable``: Adam's count and bias
correction live on the device, so a step can be captured into a CUDA
graph and replayed (``train/superstep.py``), and eager and replayed
steps take the same update, bit for bit. Under cosine there the lr is a
0-d device tensor that ``schedule_lr`` fills, outside any graph, where a
Python float would be frozen into the capture. The CPU keeps torch's
default Adam and a float lr. Checkpoints hold the lr as a float either
way (``optimizer_state``), and ``load_optimizer_state`` keeps this run's
own lr and ``capturable``, so a file written on one device resumes on the
other.

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
    """Adam over ``params``: ``capturable``, and under cosine with a device
    lr, when they are on the card (module docstring)."""
    params = list(params)
    if cfg.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r}: expected 'constant' or 'cosine'")
    if cfg.lr_schedule == "cosine":
        if cfg.max_learning_rate <= 0:
            raise ValueError("lr_schedule=cosine needs max_learning_rate > 0")
        if cfg.lr_decay_steps <= 0:
            raise ValueError("lr_schedule=cosine needs lr_decay_steps > 0 (the trainer "
                             "fills it with epochs x steps_per_epoch)")
    on_card = bool(params) and params[0].device.type == "cuda"
    lr = cfg.max_learning_rate
    if on_card and cfg.lr_schedule == "cosine":
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=1e-8,
                            capturable=on_card)


def adam_count(opt: torch.optim.Optimizer) -> int:
    """Steps the optimizer has taken (0 before the first); a host read on
    the card, so never inside a captured step."""
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


def set_lr(opt, lr: float) -> None:
    """Every group's lr to ``lr``: filled into a device lr, else assigned."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def schedule_lr(cfg: Config, state: "GANTrainState", step: Optional[int] = None) -> None:
    """Under cosine, both optimizers' lr for the update of ``step`` (the
    state's by default); nothing under the constant schedule."""
    if cfg.lr_schedule == "cosine":
        lr = cfg.max_learning_rate * cosine_factor(cfg, state.step if step is None else step)
        for opt in (state.opt_g, state.opt_d):
            set_lr(opt, lr)


_OWN_GROUP_KEYS = ("lr", "capturable")


def optimizer_state(opt) -> dict:
    """``opt.state_dict()`` with every group's lr as a float, as a CPU run
    writes it."""
    sd = opt.state_dict()
    for group in sd["param_groups"]:
        group["lr"] = float(group["lr"])
    return sd


def load_optimizer_state(opt, sd: dict) -> None:
    """``opt.load_state_dict(sd)`` keeping ``opt``'s own lr kind and
    ``capturable`` (torch places the step count by the file's flag), so a
    file written on the CPU resumes on the card and back. The caller sets
    the lr's value."""
    own = [{k: group[k] for k in _OWN_GROUP_KEYS} for group in opt.param_groups]
    opt.load_state_dict({**sd, "param_groups": [{**group, **mine} for group, mine
                                                in zip(sd["param_groups"], own)]})


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
        group["lr"] = float(group["lr"])
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
            if k not in ("params",) + _OWN_GROUP_KEYS:
                self.inner.param_groups[0][k] = v
        self.sync_params()
        if not sd.get("state"):
            return
        per = [sd["state"][i] for i in range(len(self.params))]
        self.inner.state[self.master] = {
            "step": torch.as_tensor(per[0]["step"], dtype=torch.float32).to(
                self.master.device if self.inner.defaults["capturable"] else "cpu", copy=True),
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
