"""Checkpoint evaluation: FID / IS / intra-FID outside training — port of
``jckx/evaluate.py:97-232``.

    python -m jckx_torch evaluate --ckpt save/cgan/<ts>/latest.ckpt \
        [--dataset cifar100] [--data_dir ./data] [--device cpu]

It scores a checkpoint with the trainers' own eval protocol, so a
checkpoint scored here gives what its run logged at that step (same
backbone, same seed, same batching, hence the same samples): the fixed
eval inputs of ``--seed`` (``train/gan_trainer.py``'s
``fixed_eval_inputs``), ``--sample_count`` z in one batch for DCGAN, the
class-major grid of 10 per class in chunks of 500 for CGAN (under
batch-stat BN the batching is part of the function), the EMA generator
when the file holds one, and one backbone pass for IS, FID and
intra-FID. On the card G's forwards run through the fused BN kernel.

It reads the port's ``.pt`` and ``latest.ckpt`` files and the reference's
``.pt``; a jckx ``.ckpt`` is flax msgpack and is converted first with
``python -m jckx.convert``. It prints one JSON line,
``{"step", "n", "is", "fid"[, "intra_fid"]}``.

Not ported yet, and refused by name: ``--quant int8`` (ROADMAP A12),
``--kid`` / ``--prdc`` and ``--eval_fast_stem`` (A9).
"""

from __future__ import annotations

import argparse
import json
import zipfile

import torch

from jckx_torch.checkpoint.checkpoint import load_checkpoint
from jckx_torch.checkpoint.torch_convert import infer_gan_config
from jckx_torch.configs import Config
from jckx_torch.models.cgan import CGenerator
from jckx_torch.models.dcgan import Generator
from jckx_torch.train.gan_trainer import fixed_eval_inputs, sample_eval_images
from jckx_torch.utils.device import resolve_device

# flag → (its value when off, the ROADMAP.md item that brings it)
UNPORTED = {
    "quant": ("", "A12 (int8 serving, ops/quant.py)"),
    "kid": (0, "A9 (KID and PRDC)"),
    "prdc": (0, "A9 (KID and PRDC)"),
    "eval_fast_stem": (0, "A9 (the space-to-depth InceptionV3 stem)"),
}


def get_args(argv=None):
    d = Config()
    p = argparse.ArgumentParser(description="jckx_torch checkpoint evaluation")
    p.add_argument("--ckpt", required=True,
                   help="the port's .pt or latest.ckpt, or a reference torch .pt")
    p.add_argument("--dataset", default=d.dataset,
                   help="real side: cifar100 / cifar10 / mnist / synthetic, or npz with --data_path")
    p.add_argument("--data_dir", default=d.data_dir)
    p.add_argument("--data_path", default=d.data_path)
    p.add_argument("--synthetic_size", type=int, default=d.synthetic_size)
    p.add_argument("--sample_count", type=int, default=d.sample_count,
                   help="DCGAN samples (CGAN always renders 10 per class)")
    p.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=d.seed,
                   help="eval-noise and synthetic-data seed: the run's, to reproduce its numbers")
    p.add_argument("--use_ema", type=int, default=None,
                   help="1 / 0: score the EMA generator or G (default: the EMA when the file has one)")
    p.add_argument("--metric_backbone", default=d.metric_backbone)
    p.add_argument("--save_root", default=d.save_root,
                   help="where the fine-tuned backbone is looked for (<save_root>/iception_v3)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    p.add_argument("--quant", default="", choices=["", "int8"])
    for name in ("kid", "prdc", "eval_fast_stem"):
        p.add_argument(f"--{name}", type=int, default=0)
    return p.parse_args(argv)


def load_generator(path: str, use_ema=None):
    """A checkpoint → (G on the CPU, conditional, geometry, num_classes,
    step). G is the EMA generator when ``use_ema`` says so, or by default
    when the file holds one."""
    if not zipfile.is_zipfile(path):  # torch.save writes a zip archive
        raise ValueError(
            f"{path}: not a torch checkpoint. A jckx .ckpt is flax msgpack: convert it with "
            f"`python -m jckx.convert --src {path} --dst model.pt`")
    ckpt = load_checkpoint(path)
    conditional, geo, num_classes = infer_gan_config(ckpt["model_g"], ckpt["model_d"])
    # the port's files name the dataset's class count, which sizes the
    # backbone's head for a DCGAN run too (the weights say only K = 100)
    num_classes = int(ckpt.get("serve_config", {}).get("num_classes", num_classes))
    if use_ema and "ema_g" not in ckpt:
        raise ValueError(f"{path} holds no EMA generator")
    weights = ckpt["ema_g"] if (use_ema if use_ema is not None else "ema_g" in ckpt) \
        else ckpt["model_g"]
    G = CGenerator(geo, num_classes) if conditional else Generator(geo)
    G.load_state_dict(weights, strict=True)
    adam = ckpt.get("optimizer_g", {}).get("state", {})
    step = int(ckpt.get("step", int(next(iter(adam.values()))["step"]) if adam else 0))
    return G.requires_grad_(False), conditional, geo, num_classes, step


def evaluate(args, metrics=None) -> dict:
    """→ the result dict (the printed JSON line). ``metrics`` replaces the
    InceptionV3 engine built on the dataset (the tests pass one)."""
    bad = [f"--{k} {getattr(args, k)!r}: not ported yet (ROADMAP.md {item})"
           for k, (off, item) in UNPORTED.items() if getattr(args, k) != off]
    if bad:
        raise SystemExit("jckx_torch evaluate: " + "; ".join(bad))
    device = resolve_device(args.device)
    G, conditional, geo, ncls, step = load_generator(args.ckpt, args.use_ema)
    G.to(device)
    cd = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32

    cfg = Config()
    cfg.log_file = 0  # a scoring CLI writes no log files
    for name in ("dataset", "data_dir", "data_path", "synthetic_size", "seed",
                 "metric_backbone", "save_root"):
        setattr(cfg, name, getattr(args, name))
    cfg.image_size, cfg.channels, cfg.num_classes = geo.image_size, geo.channels, ncls
    n = 10 * ncls if conditional else args.sample_count

    if metrics is None:
        from jckx_torch.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
        from jckx_torch.metrics.metrics import Metrics

        pre = (CGANDataPreprocessor if conditional else DCGANDataPreprocessor)(cfg)
        if conditional and pre.num_classes != ncls:
            raise ValueError(f"the checkpoint has {ncls} classes, dataset {args.dataset} "
                             f"has {pre.num_classes}")
        metrics = Metrics(pre.metric_source, cfg, batch_size=args.eval_batch_size,
                          compute_dtype=cd, cache_dir=cfg.data_dir, num_classes=ncls,
                          device=device)

    z, onehot = fixed_eval_inputs(cfg.seed, geo, conditional, ncls, n, device)
    fake = sample_eval_images(G, z, onehot, cd)
    feats = metrics.extract_features(fake)
    result = {"step": step, "n": n,
              "is": float(metrics.inception_score(logits=feats)),
              "fid": float(metrics.fid(features=feats))}
    if conditional:
        result["intra_fid"] = float(metrics.intra_fid(features=feats))
    return result


def main(argv=None) -> dict:
    result = evaluate(get_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
