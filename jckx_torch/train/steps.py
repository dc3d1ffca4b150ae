"""The DCGAN and CGAN train steps — port of ``make_dcgan_train_step``
(``jckx/train/steps.py:179-252``) and ``make_cgan_train_step``
(``:331-403``): the faithful steps, FusedProp (``:124-177``, ``:272-329``)
and ``--remat`` (``_maybe_remat``, ``:65-71``).

One faithful call runs one iteration of the reference loop (dcgan_trainer.py:130-189,
cgan_trainer.py:190-213) and updates the state in place:

1. blend the real batch with instance noise; draw z and the fake noise;
2. build the fake once from the current G. D's pass uses it detached.
   G's parameters do not change before the G pass, so the same forward
   (with its graph) serves G's loss too, as the reference does
   (dcgan_trainer.py:168-185);
3. D's loss: BCE on real and fake against 0.9 / 0.1, plus λ·GP on the
   sigmoid score at α-interpolates of the noisy real and the detached
   noisy fake. DCGAN: ``gp_in_d_grad`` decides whether the penalty enters
   D's gradient (the reference DCGAN leaves it out); CGAN: it always does
   (cgan_trainer.py:201-203). The reported ``loss_d`` includes it either
   way. Update D;
4. G's loss through the **updated** D, with the same fake noise. The
   backward of this pass is taken for G's parameters only, so no grad is
   formed for D's. Update G, then the EMA of G.

CGAN conditions G and every D pass on the batch's one-hot labels, and each
of its four D passes (real, fake, penalty, G pass) takes a fresh dropout
keep-mask, jckx's ``k_dr``, ``k_df``, ``k_di`` and ``k_dg`` (``:333``).

FusedProp (``cfg.fused_prop``, arXiv:2004.03335) shares one fake-side D
forward between the players. G runs forward once; D's real and penalty
sides are differentiated as above, on the detached fake; one D forward on
the fake as a leaf then gives two cotangent pulls: D's fake-loss gradient
and G's loss gradient at the fake, which is chained through G's forward.
Both gradients are taken before either Adam step, so G's gradient flows
through the PRE-update D (a simultaneous update, not the reference's
alternating one), the reported ``d_gz2`` equals ``d_gz1``, and CGAN's
shared forward takes one dropout mask, ``keep_fake`` (jckx's ``k_df``;
``keep_g`` is drawn and unused, as jckx's ``_unused_k_dg``, so both modes
draw the same numbers for one (seed, step)). The port's faithful step
already reuses G's one forward, so FusedProp saves one fake-side D
forward here, not jckx's "one G and one D forward".

``cfg.remat`` ``g`` / ``d`` / ``both`` runs G's and / or D's forward under
``torch.utils.checkpoint`` with ``use_reentrant=False``: activations are
recomputed in the backward instead of kept. The non-reentrant form keeps
grad mode in its first forward (the reentrant one runs it under
``no_grad``, where ``bn_act`` would take the kernel on an input the
penalty differentiates twice) and stays twice differentiable for the
penalty. The recompute reruns the forward, so the forward must have no
side effect: the norms' running buffers are never written, the kernel is
never launched in the step, and the dropout masks are explicit inputs.
The forwards draw nothing, so the checkpoint does not save and restore
the RNG state (``preserve_rng_state=False``), which a CUDA graph capture
forbids; the recompute is the same function either way.

A made step is ``step(state, real, ..., draws=None)``: the draws of
(seed, step) when none are injected, the lr of the step
(``state.schedule_lr``), the step's device work, ``state.step += 1``.
Its ``step.body(state, real, ..., draws)`` is the device work alone: no
host read, no lr, no count, so ``train/superstep.py`` can capture it
into a CUDA graph, and does the rest on the host around each replay.

The random draws (real noise, z, fake noise, α, and CGAN's masks) come
from a ``torch.Generator`` on the batch's device, seeded from (seed, step),
so a restored state draws what the uninterrupted run would. ``draws`` lets
a test inject jckx's.

Data parallel over a mesh (``mesh``, ``parallel/mesh.py``; jckx jits the
step with the batch on ``data`` and the state replicated,
``jckx/train/steps.py:405-439``): each rank steps on its rows of the
global batch. It draws the global batch's draws from the generator of
(seed, step), as the single-rank run does, and keeps its rows
(``shard_draws``). Every BN layer takes the global statistics through an
all-reduce inside autograd, so the penalty's input gradient, and its
second-order terms, carry every rank's rows. After each backward the
model's gradients are averaged over the ranks through one flat buffer,
once per model per update (D, then G through the updated D; FusedProp
both), so every rank takes the same Adam step and the replicas stay
bit-identical. The telemetry is averaged too, so every rank returns the
global values. ``--remat`` recomputes forwards that hold collectives:
every rank recomputes in the same order. Every bn_act in the step has an input that requires
grad, so on the card it takes the differentiable plain composition, never
the kernel (``kernels/fused_bn_act.py``).

With a model axis (a ``(D, M)`` mesh; jckx ``:405-439`` with
``tp_state_sharding`` or the spatial constraint) the M ranks of a model
group step on the same rows and draws, and the nets run in
``cfg.model_axis_mode``'s layout (``parallel/layout.py``): under ``tp``
each rank's nets hold their slices of the wide layers and gather each
sliced activation along channels; under ``spatial`` the images, the noise
and every activation are the rank's block of rows, with halo exchanges
around the convolutions (``_localize`` takes the blocks of the batch and
the draws). The penalty reads its input gradient through the layout, and
``ProcessMesh.average_grads`` turns every rank's gradients into the
global mean's (sharded leaves over the data axis, replicated ones over
the world); a ``ShardedAdam`` (``--spatial_replicate_grads 0``) reduces
its own.

→ the six telemetry scalars of jckx, f32 tensors on the device, detached.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from jckx_torch.configs import Config
from jckx_torch.models.cgan import DROPOUT, HIDDEN
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.ops.losses import bce_from_logits, gradient_penalty, instance_noise_blend
from jckx_torch.parallel.layout import make_layout
from jckx_torch.parallel.tp import sharded_flags
from jckx_torch.train.state import GANTrainState, schedule_lr

METRIC_NAMES = ("loss_d", "gp", "d_x", "d_gz1", "loss_g", "d_gz2")


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


@dataclass
class StepDraws:
    """One step's random inputs, f32: images NHWC, α (N, 1, 1, 1); for
    CGAN the dropout keep-masks (N, 256) of D's real, fake, penalty and G
    passes (None for DCGAN)."""

    real_noise: torch.Tensor
    z: torch.Tensor
    fake_noise: torch.Tensor
    alpha: torch.Tensor
    keep_real: Optional[torch.Tensor] = None
    keep_fake: Optional[torch.Tensor] = None
    keep_gp: Optional[torch.Tensor] = None
    keep_g: Optional[torch.Tensor] = None


def derive_seed(seed: int, tag: str, count: int) -> int:
    """A 63-bit generator seed from (seed, tag, count)."""
    digest = hashlib.sha256(f"{seed}:{tag}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_draws(seed: int, step: int, n: int, geo: GANGeometry,
               device: torch.device, conditional: bool = False) -> StepDraws:
    """The step's draws from the generator of (seed, step); CGAN's four
    keep-masks (keep with probability 0.75) follow DCGAN's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "step", step))
    shape = (n, geo.image_size, geo.image_size, geo.channels)

    def normal(*s):
        return torch.randn(s, generator=gen, device=device)

    draws = StepDraws(real_noise=normal(*shape), z=normal(n, geo.z_dim),
                      fake_noise=normal(*shape),
                      alpha=torch.rand((n, 1, 1, 1), generator=gen, device=device))
    if conditional:
        for name in ("keep_real", "keep_fake", "keep_gp", "keep_g"):
            mask = torch.rand((n, HIDDEN), generator=gen, device=device) < 1.0 - DROPOUT
            setattr(draws, name, mask.float())
    return draws


def shard_draws(draws: StepDraws, mesh) -> StepDraws:
    """This rank's rows of a global batch's draws (the draws themselves
    with no mesh)."""
    if mesh is None:
        return draws
    return StepDraws(**{k: None if v is None else mesh.rows(v) for k, v in vars(draws).items()})


def _average_grads(mesh, module, opt) -> None:
    """The gradient of the global mean loss on every rank (``average_grads``
    over the mesh, sharded leaves by their flags); an optimizer that
    reduces its own gradients (``ShardedAdam``) does it in its step."""
    if mesh is not None and not getattr(opt, "reduces_grads", False):
        mesh.average_grads(module.parameters(), sharded_flags(module))


def _telemetry(out: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The six scalars, f32 and detached, averaged over the mesh's ranks."""
    vals = torch.stack([out[k].detach().float() for k in METRIC_NAMES])
    if mesh is not None:
        vals = mesh.mean(vals)
    return dict(zip(METRIC_NAMES, vals.unbind()))


def _maybe_remat(fn: Callable, on: bool) -> Callable:
    """``fn`` under non-reentrant activation checkpointing when ``on``."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _update_ema(cfg: Config, state: GANTrainState) -> None:
    if state.ema_g is not None:
        with torch.no_grad():
            e, p = list(state.ema_g.parameters()), list(state.G.parameters())
            torch._foreach_mul_(e, cfg.ema_decay)
            torch._foreach_add_(e, p, alpha=1.0 - cfg.ema_decay)


def _gan_step(cfg: Config, state: GANTrainState, real: torch.Tensor, draws: StepDraws,
              G: Callable, D: Callable, gp_in_grad: bool, mesh=None,
              layout=None) -> Dict[str, torch.Tensor]:
    """The faithful iteration shared by both families. ``G(z)`` builds the
    fake; ``D(x, keep)`` gives logits under the pass's dropout mask;
    ``mesh`` averages the gradients and the telemetry over its ranks;
    ``layout`` is the model axis's (the penalty reads its input gradient
    through it)."""
    cd = compute_dtype(cfg)
    lam, f = cfg.lambda_gp, cfg.instance_noise
    real_n = instance_noise_blend(real.to(cd), draws.real_noise, f)
    fake_noise = draws.fake_noise.to(cd)
    fake = G(draws.z)
    fake_n = (1.0 - f) * fake.detach() + f * fake_noise

    # ---- D update ----------------------------------------------------
    logits_r = D(real_n, draws.keep_real)
    logits_f = D(fake_n, draws.keep_fake)
    bce = (bce_from_logits(logits_r, cfg.label_real)
           + bce_from_logits(logits_f, cfg.label_fake))
    gp = gradient_penalty(lambda x: torch.sigmoid(D(x, draws.keep_gp)), draws.alpha,
                          real_n, fake_n, create_graph=gp_in_grad, layout=layout,
                          image_h=cfg.image_size)
    loss_for_grad = bce + lam * gp if gp_in_grad else bce
    state.opt_d.zero_grad(set_to_none=True)
    loss_for_grad.backward()
    _average_grads(mesh, state.D, state.opt_d)
    state.opt_d.step()

    # ---- G update, through the updated D -----------------------------
    logits_g = D((1.0 - f) * fake + f * fake_noise, draws.keep_g)
    loss_g = bce_from_logits(logits_g, cfg.label_real)
    state.opt_g.zero_grad(set_to_none=True)
    # only G's gradient: D's weight gradients of this pass are never formed
    loss_g.backward(inputs=list(state.G.parameters()))
    _average_grads(mesh, state.G, state.opt_g)
    state.opt_g.step()
    _update_ema(cfg, state)

    with torch.no_grad():
        return _telemetry({"loss_d": bce + lam * gp, "gp": gp,
                           "d_x": torch.sigmoid(logits_r).mean(),
                           "d_gz1": torch.sigmoid(logits_f).mean(),
                           "loss_g": loss_g, "d_gz2": torch.sigmoid(logits_g).mean()}, mesh)


def _fused_prop_step(cfg: Config, state: GANTrainState, real: torch.Tensor, draws: StepDraws,
                     G: Callable, D: Callable, gp_in_grad: bool,
                     mesh=None, layout=None) -> Dict[str, torch.Tensor]:
    """The FusedProp iteration (jckx ``step_fp``, ``_fused_prop_fake_side``
    ``:74-90``); arguments as ``_gan_step``'s."""
    cd = compute_dtype(cfg)
    lam, f = cfg.lambda_gp, cfg.instance_noise
    real_n = instance_noise_blend(real.to(cd), draws.real_noise, f)
    fake_noise = draws.fake_noise.to(cd)
    fake_n = (1.0 - f) * G(draws.z) + f * fake_noise  # the step's only G forward
    params_d = list(state.D.parameters())

    # ---- D's real and penalty sides, on the detached fake ---------------
    logits_r = D(real_n, draws.keep_real)
    bce_r = bce_from_logits(logits_r, cfg.label_real)
    gp = gradient_penalty(lambda x: torch.sigmoid(D(x, draws.keep_gp)), draws.alpha,
                          real_n, fake_n.detach(), create_graph=gp_in_grad, layout=layout,
                          image_h=cfg.image_size)
    grads_d = torch.autograd.grad(bce_r + lam * gp if gp_in_grad else bce_r, params_d)

    # ---- the shared fake side: one D forward, two cotangent pulls --------
    fake_leaf = fake_n.detach().requires_grad_(True)
    logits_f = D(fake_leaf, draws.keep_fake)
    bce_f = bce_from_logits(logits_f, cfg.label_fake)
    loss_g = bce_from_logits(logits_f, cfg.label_real)
    grads_f = torch.autograd.grad(bce_f, params_d, retain_graph=True)
    (dx,) = torch.autograd.grad(loss_g, fake_leaf)

    # ---- both gradients exist before either update -----------------------
    state.opt_g.zero_grad(set_to_none=True)
    fake_n.backward(dx)  # G's chain from the fake's cotangent
    for p, a, b in zip(params_d, grads_d, grads_f):
        p.grad = a + b
    _average_grads(mesh, state.D, state.opt_d)
    _average_grads(mesh, state.G, state.opt_g)
    state.opt_d.step()
    state.opt_g.step()
    _update_ema(cfg, state)

    with torch.no_grad():
        d_gz = torch.sigmoid(logits_f).mean()
        return _telemetry({"loss_d": bce_r + bce_f + lam * gp, "gp": gp,
                           "d_x": torch.sigmoid(logits_r).mean(), "d_gz1": d_gz,
                           "loss_g": loss_g, "d_gz2": d_gz}, mesh)  # one shared forward


def _step_fn(cfg: Config) -> Callable:
    return _fused_prop_step if cfg.fused_prop else _gan_step


def _advance(cfg: Config, state: GANTrainState, work: Callable) -> Dict[str, torch.Tensor]:
    """A made step around its device work (module docstring): the lr of
    ``state.step``, ``work()``, then ``state.step += 1``."""
    schedule_lr(cfg, state)
    out = work()
    state.step += 1
    return out


def _remat_flags(cfg: Config):
    """(remat G, remat D) from ``cfg.remat``."""
    if cfg.remat not in ("none", "g", "d", "both"):
        raise ValueError(f"remat={cfg.remat!r}: expected none, g, d or both")
    return cfg.remat in ("g", "both"), cfg.remat in ("d", "both")


def rank_draws(seed: int, step: int, local_n: int, geo: GANGeometry, device: torch.device,
               mesh, conditional: bool) -> StepDraws:
    """The draws of (seed, step) for the global batch of which this rank
    holds ``local_n`` rows, this rank's rows of them (every route's rule:
    the eager step's, the superstep's feed's, jckx's)."""
    n = local_n * (mesh.size if mesh is not None else 1)
    return shard_draws(make_draws(seed, step, n, geo, device, conditional), mesh)


def _localize(layout, real: torch.Tensor, draws: StepDraws):
    """This member's part of its data rows: under ``spatial`` a block of
    the images' height (the batch and the noise), as jckx constrains the
    decoded batch to ``P("data", "model", None, None)``."""
    if layout is None:
        return real, draws
    return layout.images(real), dataclasses.replace(
        draws, real_noise=layout.images(draws.real_noise),
        fake_noise=layout.images(draws.fake_noise))


def make_dcgan_train_step(cfg: Config, geo: GANGeometry, mesh=None) -> Callable:
    """→ ``step(state, real, draws=None) -> {name: f32 scalar}``; ``real`` is
    the decoded batch (N, S, S, C) in [-1, 1] on the state's device: over
    ``mesh``, this rank's rows, and ``draws`` (when injected) this rank's.
    With a model axis the nets run in ``cfg.model_axis_mode``'s layout."""
    cd = compute_dtype(cfg)
    run, (remat_g, remat_d) = _step_fn(cfg), _remat_flags(cfg)
    layout = make_layout(mesh, cfg.model_axis_mode)

    def body(state: GANTrainState, real: torch.Tensor,
             draws: StepDraws) -> Dict[str, torch.Tensor]:
        real, draws = _localize(layout, real, draws)
        G = _maybe_remat(lambda z: state.G(z, cd, mesh=mesh, par=layout), remat_g)
        D = _maybe_remat(lambda x: state.D(x, cd, mesh=mesh, par=layout), remat_d)
        return run(cfg, state, real, draws, G=G, D=lambda x, keep: D(x),
                   gp_in_grad=cfg.gp_in_d_grad, mesh=mesh, layout=layout)

    def step(state: GANTrainState, real: torch.Tensor,
             draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = rank_draws(state.seed, state.step, real.shape[0], geo, real.device, mesh,
                               conditional=False)
        return _advance(cfg, state, lambda: body(state, real, draws))

    step.body = body
    return step


def make_cgan_train_step(cfg: Config, geo: GANGeometry, mesh=None) -> Callable:
    """→ ``step(state, real, onehot, draws=None) -> {name: f32 scalar}``;
    ``onehot`` (N, K) holds the batch's labels; ``mesh`` as for DCGAN."""
    cd = compute_dtype(cfg)
    run, (remat_g, remat_d) = _step_fn(cfg), _remat_flags(cfg)
    layout = make_layout(mesh, cfg.model_axis_mode)

    def body(state: GANTrainState, real: torch.Tensor, onehot: torch.Tensor,
             draws: StepDraws) -> Dict[str, torch.Tensor]:
        real, draws = _localize(layout, real, draws)
        onehot = onehot.float()
        G = _maybe_remat(lambda z: state.G(z, onehot, cd, mesh=mesh, par=layout), remat_g)
        D = _maybe_remat(lambda x, keep: state.D(x, onehot, cd, keep, mesh=mesh, par=layout),
                         remat_d)
        return run(cfg, state, real, draws, G=G, D=D, gp_in_grad=True, mesh=mesh,
                   layout=layout)

    def step(state: GANTrainState, real: torch.Tensor, onehot: torch.Tensor,
             draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = rank_draws(state.seed, state.step, real.shape[0], geo, real.device, mesh,
                               conditional=True)
        return _advance(cfg, state, lambda: body(state, real, onehot, draws))

    step.body = body
    return step
