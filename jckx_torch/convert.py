"""Checkpoint conversion: the reference's torch ``.pt`` ↔ the port's
checkpoint — port of ``jckx/convert.py``.

    python -m jckx_torch convert --src 5000_0.1000_88.4000.pt --dst run/latest.ckpt [--with_ema]
    python -m jckx_torch convert --src save/dcgan/<ts>/latest.ckpt --dst export.pt [--use_ema]

The direction follows ``--dst``'s extension. The port's files are torch
dicts: the reference's ``{model_g, model_d, optimizer_g, optimizer_d}``
(train/dcgan_trainer.py:86-91), and the port's (``checkpoint/
checkpoint.py``), the same dict plus ``step``, ``seed``, ``ema_g`` when the
run kept an EMA, and the trainer's ``serve_config``. A ``--src`` ``.ckpt``
written by jckx (flax msgpack) is read as it is (``load_checkpoint``), so
``.ckpt`` → ``.pt`` writes the ``.pt`` that ``python -m jckx.convert``
writes from it, without JAX.

- ``.pt`` → checkpoint: the step is the Adam count (jckx's importer reads
  it so), the seed the reference's; ``--with_ema`` seeds ``ema_g`` with a
  copy of G; ``serve_config`` records what the weights say.
- checkpoint → ``.pt``: the four keys only, strictly loadable by the
  reference's modules; ``--use_ema`` puts the EMA generator in G's slot.

Geometry and conditioning come from the weights. ``--conditional``,
``--num_classes`` and the geometry flags are jckx's hints; here they are
checked against the weights and raise where they contradict them. ``--lr``
is written into both optimizers' param groups. Adam state absent from the
source is written fresh (count 0).
"""

from __future__ import annotations

import argparse
import json

import torch

from jckx_torch.checkpoint.checkpoint import (GEOMETRY_FIELDS, checkpoint_step, load_checkpoint,
                                              save_checkpoint)
from jckx_torch.checkpoint.torch_convert import infer_gan_config
from jckx_torch.configs import RANDOMSEED, Config
from jckx_torch.models.cgan import CDiscriminator, CGenerator
from jckx_torch.models.dcgan import Discriminator, Generator


def get_args(argv=None):
    p = argparse.ArgumentParser(description="jckx_torch checkpoint conversion")
    p.add_argument("--src", required=True, help="source: a reference .pt or the port's checkpoint")
    p.add_argument("--dst", required=True, help="destination: .pt (reference) or a checkpoint")
    p.add_argument("--lr", type=float, default=2e-4,
                   help="the optimizers' lr written into their param groups")
    p.add_argument("--use_ema", action="store_true",
                   help="checkpoint -> .pt: export the EMA generator in G's slot")
    p.add_argument("--with_ema", action="store_true",
                   help=".pt -> checkpoint: seed the EMA slot with a copy of G")
    # structure hints, checked against the weights
    p.add_argument("--conditional", action="store_true", default=None)
    p.add_argument("--num_classes", type=int, default=None)
    for name in GEOMETRY_FIELDS:
        p.add_argument(f"--{name}", type=int, default=None)
    return p.parse_args(argv)


def _optimizer(state_dict, net: torch.nn.Module, lr: float) -> dict:
    """An Adam state dict for ``net`` with ``lr`` in its param groups: the
    source's, or a fresh one (count 0) when the source has none."""
    if not state_dict or not state_dict.get("param_groups"):
        betas = (Config.adam_beta1, Config.adam_beta2)
        state_dict = torch.optim.Adam(net.parameters(), lr=lr, betas=betas).state_dict()
    return {**state_dict, "param_groups": [{**g, "lr": lr} for g in state_dict["param_groups"]]}


def convert(args) -> dict:
    """→ the info dict describing what was written (the printed JSON line)."""
    to_reference = args.dst.endswith(".pt")
    if args.src.endswith(".pt") == to_reference:
        raise ValueError(f"one side must be .pt (the reference's) and the other the port's "
                         f"checkpoint (src={args.src}, dst={args.dst})")
    ckpt = load_checkpoint(args.src)  # the port's, the reference's or jckx's
    conditional, geo, k = infer_gan_config(ckpt["model_g"], ckpt["model_d"])
    k = int(ckpt.get("serve_config", {}).get("num_classes", k))
    inferred = {"conditional": conditional, "num_classes": k,
                **{f: getattr(geo, f) for f in GEOMETRY_FIELDS}}
    clashes = {f: (getattr(args, f), v) for f, v in inferred.items()
               if getattr(args, f) is not None and getattr(args, f) != v}
    if clashes:
        raise ValueError(f"{args.src}: flags contradict the checkpoint's weights (given vs "
                         f"inferred): {clashes}")
    G = CGenerator(geo, k) if conditional else Generator(geo)
    D = CDiscriminator(geo, k) if conditional else Discriminator(geo)
    step = checkpoint_step(ckpt)
    info = {"wrote": args.dst, "step": step, **inferred}
    if to_reference:
        if args.use_ema and "ema_g" not in ckpt:
            raise ValueError(f"{args.src} holds no EMA generator (--use_ema)")
        out = {"model_g": ckpt["ema_g" if args.use_ema else "model_g"], "model_d": ckpt["model_d"],
               "optimizer_g": _optimizer(ckpt.get("optimizer_g"), G, args.lr),
               "optimizer_d": _optimizer(ckpt.get("optimizer_d"), D, args.lr)}
    else:
        ema = args.with_ema or "ema_g" in ckpt
        out = {"model_g": ckpt["model_g"], "model_d": ckpt["model_d"],
               "optimizer_g": _optimizer(ckpt.get("optimizer_g"), G, args.lr),
               "optimizer_d": _optimizer(ckpt.get("optimizer_d"), D, args.lr),
               "step": step, "seed": int(ckpt.get("seed", RANDOMSEED)),
               "serve_config": {**inferred, "ema": ema}}
        if ema:
            out["ema_g"] = ckpt.get("ema_g", ckpt["model_g"])
        info["ema"] = ema
    # the strict load checks every tensor's name and shape before writing
    G.load_state_dict(out["model_g"], strict=True)
    D.load_state_dict(out["model_d"], strict=True)
    save_checkpoint(args.dst, out)
    return info


def main(argv=None) -> int:
    print(json.dumps(convert(get_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
