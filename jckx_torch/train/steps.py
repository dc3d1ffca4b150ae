"""The DCGAN and CGAN train steps — port of ``make_dcgan_train_step``
(``jckx/train/steps.py:179-252``) and ``make_cgan_train_step``
(``:331-403``), the faithful steps. FusedProp (``:124-177``, ``:274-329``)
is not ported yet (ROADMAP A3); the CLI refuses it by name.

One call runs one iteration of the reference loop (dcgan_trainer.py:130-189,
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
4. G's loss through the **updated** D, with the same fake noise. D's
   parameters are frozen for this pass, so no grad is taken for them.
   Update G, then the EMA of G.

CGAN conditions G and every D pass on the batch's one-hot labels, and each
of its four D passes (real, fake, penalty, G pass) takes a fresh dropout
keep-mask, jckx's ``k_dr``, ``k_df``, ``k_di`` and ``k_dg`` (``:333``).

The random draws (real noise, z, fake noise, α, and CGAN's masks) come
from a ``torch.Generator`` on the batch's device, seeded from (seed, step),
so a restored state draws what the uninterrupted run would. ``draws`` lets
a test inject jckx's. Every bn_act in the step has an input that requires
grad, so on the card it takes the differentiable plain composition, never
the kernel (``kernels/fused_bn_act.py``).

→ the six telemetry scalars of jckx, f32 tensors on the device, detached.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from jckx_torch.configs import Config
from jckx_torch.models.cgan import DROPOUT, HIDDEN
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.ops.losses import bce_from_logits, gradient_penalty, instance_noise_blend
from jckx_torch.train.state import GANTrainState, adam_step

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


def _gan_step(cfg: Config, state: GANTrainState, real: torch.Tensor, draws: StepDraws,
              G: Callable, D: Callable, gp_in_grad: bool) -> Dict[str, torch.Tensor]:
    """The iteration shared by both families. ``G(z)`` builds the fake;
    ``D(x, keep)`` gives logits under the pass's dropout mask."""
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
                          real_n, fake_n, create_graph=gp_in_grad)
    loss_for_grad = bce + lam * gp if gp_in_grad else bce
    state.opt_d.zero_grad(set_to_none=True)
    loss_for_grad.backward()
    adam_step(state.opt_d, cfg)

    # ---- G update, through the updated D -----------------------------
    state.D.requires_grad_(False)
    try:
        logits_g = D((1.0 - f) * fake + f * fake_noise, draws.keep_g)
    finally:
        state.D.requires_grad_(True)
    loss_g = bce_from_logits(logits_g, cfg.label_real)
    state.opt_g.zero_grad(set_to_none=True)
    loss_g.backward()
    adam_step(state.opt_g, cfg)

    if state.ema_g is not None:
        with torch.no_grad():
            e, p = list(state.ema_g.parameters()), list(state.G.parameters())
            torch._foreach_mul_(e, cfg.ema_decay)
            torch._foreach_add_(e, p, alpha=1.0 - cfg.ema_decay)
    state.step += 1

    with torch.no_grad():
        out = {"loss_d": bce + lam * gp, "gp": gp,
               "d_x": torch.sigmoid(logits_r).mean(),
               "d_gz1": torch.sigmoid(logits_f).mean(),
               "loss_g": loss_g, "d_gz2": torch.sigmoid(logits_g).mean()}
        return {k: v.detach().float() for k, v in out.items()}


def make_dcgan_train_step(cfg: Config, geo: GANGeometry) -> Callable:
    """→ ``step(state, real, draws=None) -> {name: f32 scalar}``; ``real`` is
    the decoded batch (N, S, S, C) in [-1, 1] on the state's device."""
    cd = compute_dtype(cfg)

    def step(state: GANTrainState, real: torch.Tensor,
             draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(state.seed, state.step, real.shape[0], geo, real.device)
        return _gan_step(cfg, state, real, draws, G=lambda z: state.G(z, cd),
                         D=lambda x, keep: state.D(x, cd), gp_in_grad=cfg.gp_in_d_grad)

    return step


def make_cgan_train_step(cfg: Config, geo: GANGeometry) -> Callable:
    """→ ``step(state, real, onehot, draws=None) -> {name: f32 scalar}``;
    ``onehot`` (N, K) holds the batch's labels."""
    cd = compute_dtype(cfg)

    def step(state: GANTrainState, real: torch.Tensor, onehot: torch.Tensor,
             draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(state.seed, state.step, real.shape[0], geo, real.device,
                               conditional=True)
        onehot = onehot.float()
        return _gan_step(cfg, state, real, draws, G=lambda z: state.G(z, onehot, cd),
                         D=lambda x, keep: state.D(x, onehot, cd, keep), gp_in_grad=True)

    return step
