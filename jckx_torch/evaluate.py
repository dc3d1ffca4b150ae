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
intra-FID. On the card G's forwards run through the fused BN kernel, each
a replay of one CUDA graph per forward shape, as the trainer's eval
sampler (``gan_trainer.eval_program``; jckx jits its sampler,
``jckx/evaluate.py:203-211``), and the metrics engine's InceptionV3
forwards replay too (``metrics.Metrics``). Over a NCCL mesh (``--mesh_shape
N``) the sampler's graph holds the rank's rows, G's sync-BN and the ordered
gather; over gloo both stay eager. The log names the route.

It reads the port's ``.pt`` and ``latest.ckpt`` files, the reference's
``.pt`` and jckx's ``.ckpt`` through ``checkpoint.load_generator``, the
reader serving uses. It prints one JSON line,
``{"step", "n"[, "quant"][, "truncation"], "is", "fid"[, "intra_fid"]
[, "kid", "kid_std"][, "precision", "recall", "density", "coverage"]}``.

``--conditional``, ``--num_classes`` and the geometry flags (``--z_dim``,
``--image_size``, ``--channels``, ``--base_width``) are jckx's explicit
overrides: ``load_generator`` holds them against the weights and raises on
a contradiction. ``--use_ema`` alone (jckx's bare flag) or ``1`` scores
the EMA generator, ``0`` G.

``--kid 1`` and ``--prdc 1`` add KID and precision / recall / density /
coverage from the same extraction (``metrics/extra.py``;
``jckx/evaluate.py:228-231``). ``--eval_fast_stem 1`` runs the backbone's
first convolution in its space-to-depth form, to rescore a run trained
with it (its real features are cached under their own key).

``--quant int8`` scores the serving sampler's W8A8 forward through the same
``ops/quant.make_sampler``: the int8 params scored with ``--calib_seed s``
are, bit for bit, those that ``serve --quant int8 --seed s`` serves (both
default to 0), while ``--seed`` keeps driving the eval noise.
``--truncation t`` draws the eval z from N(0, 1) truncated to [-t, t], the
law ``serve --truncation t`` deploys (``jckx/evaluate.py:79-93``).

``--mesh_shape N`` scores over a process group of N ranks, one per GPU
(``torchrun --nproc_per_node N -m jckx_torch evaluate --mesh_shape N ...``;
``jckx/evaluate.py:150-160``): each rank renders its rows of every G
forward with the global BN statistics and gathers them, the feature
extraction runs data-parallel (``metrics.Metrics``), and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json

import torch

from jckx_torch.checkpoint.checkpoint import GEOMETRY_FIELDS, load_generator
from jckx_torch.configs import Config
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.ops.quant import make_sampler
from jckx_torch.parallel.mesh import process_mesh
from jckx_torch.train.gan_trainer import eval_program, fixed_eval_inputs, sample_eval_images
from jckx_torch.utils.device import resolve_device
from jckx_torch.utils.graphs import graph_for


def get_args(argv=None):
    d = Config()
    p = argparse.ArgumentParser(description="jckx_torch checkpoint evaluation")
    p.add_argument("--ckpt", required=True,
                   help="the port's .pt or latest.ckpt, a reference torch .pt or a jckx .ckpt")
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
    p.add_argument("--use_ema", type=int, nargs="?", const=1, default=None,
                   help="score the EMA generator (bare flag or 1) or G (0); default: the EMA "
                        "when the file has one")
    # explicit overrides, checked against the weights (a contradiction raises)
    p.add_argument("--conditional", action="store_true", default=None)
    p.add_argument("--num_classes", type=int, default=None)
    for name in GEOMETRY_FIELDS:
        p.add_argument(f"--{name}", type=int, default=None)
    p.add_argument("--metric_backbone", default=d.metric_backbone)
    p.add_argument("--save_root", default=d.save_root,
                   help="where the fine-tuned backbone is looked for (<save_root>/iception_v3)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 = score the W8A8 serving sampler instead of the float one")
    p.add_argument("--truncation", type=float, default=0.0,
                   help="draw the eval z from N(0,1) truncated to [-t, t]; 0 = off")
    p.add_argument("--calib_seed", type=int, default=0,
                   help="int8 calibration seed: the serving process's --seed (default 0 on both)")
    p.add_argument("--kid", type=int, default=0,
                   help="1 = also report the Kernel Inception Distance (kid, kid_std)")
    p.add_argument("--prdc", type=int, default=0,
                   help="1 = also report precision / recall / density / coverage")
    p.add_argument("--eval_fast_stem", type=int, default=0,
                   help="1 = the space-to-depth InceptionV3 stem: pass it to rescore a run "
                        "trained with --eval_fast_stem 1 (features differ at rounding level)")
    p.add_argument("--mesh_shape", default=d.mesh_shape,
                   help="N = score over N ranks of a process group, one per GPU (torchrun "
                        "--nproc_per_node N); '' = one process")
    return p.parse_args(argv)


def evaluate(args, metrics=None) -> dict:
    """→ the result dict (the printed JSON line). ``metrics`` replaces the
    InceptionV3 engine built on the dataset (the tests pass one)."""
    trunc = float(args.truncation)
    if trunc < 0:  # checked before the (slow) load, as serve refuses it
        raise ValueError(f"truncation {trunc} must be >= 0 (0 = off)")
    device = resolve_device(args.device)
    mesh = process_mesh(args.mesh_shape, device=device, what="evaluate")
    use_ema = None if args.use_ema is None else bool(args.use_ema)
    geo_overrides = {k: getattr(args, k) for k in GEOMETRY_FIELDS if getattr(args, k) is not None}
    G, conditional, geo, ncls, step, _ = load_generator(
        args.ckpt, use_ema, conditional=args.conditional, num_classes=args.num_classes,
        geo_overrides=geo_overrides)
    G.to(device)
    cd = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32

    cfg = Config()
    cfg.log_file = 0  # a scoring CLI writes no log files
    for name in ("dataset", "data_dir", "data_path", "synthetic_size", "seed",
                 "metric_backbone", "save_root", "eval_fast_stem"):
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
                          device=device, mesh=mesh)

    z, onehot = fixed_eval_inputs(cfg.seed, geo, conditional, ncls, n, device, truncation=trunc)
    params, apply = make_sampler(G, quant=args.quant or None, compute_dtype=cd,
                                 seed=args.calib_seed)

    # G's call signature over the sampler: (z, cd) for DCGAN, (z, one-hot, cd) for CGAN
    def sampler(zz, *rest, mesh=None):
        return apply(params, zz, rest[0] if conditional else None, mesh)

    graph, why_eager = graph_for(device, mesh=mesh)
    MainLogger(cfg).debug("eval sampler: " + (
        "one CUDA graph per G forward shape" + (", the mesh's collectives inside it"
                                                if mesh is not None else "")
        if graph else f"eager, {why_eager}"))
    fake = sample_eval_images(sampler, z, onehot, cd, mesh,
                              eval_program(sampler, cd, device, graph, mesh))
    feats = metrics.extract_features(fake)
    result = {"step": step, "n": n,
              **({"quant": "int8"} if args.quant == "int8" else {}),
              **({"truncation": trunc} if trunc > 0 else {}),
              "is": float(metrics.inception_score(logits=feats)),
              "fid": float(metrics.fid(features=feats))}
    if conditional:
        result["intra_fid"] = float(metrics.intra_fid(features=feats))
    if args.kid:
        result["kid"], result["kid_std"] = metrics.kid(features=feats)
    if args.prdc:
        result.update(metrics.prdc(features=feats))
    return result


def main(argv=None) -> dict:
    result = evaluate(get_args(argv))
    if not (torch.distributed.is_initialized() and torch.distributed.get_rank() > 0):
        print(json.dumps(result))  # rank 0 prints
    return result


if __name__ == "__main__":
    main()
