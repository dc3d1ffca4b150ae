"""``python -m jckx_torch <command> [args...]`` — port of ``jckx/__main__.py``:

    python -m jckx_torch train -m CGAN --dataset synthetic -e 1
    python -m jckx_torch evaluate --ckpt save/cgan/<ts>/latest.ckpt --kid 1 --prdc 1
    python -m jckx_torch serve --ckpt gen.pt2 --listen 8000
    python -m jckx_torch export --ckpt save/dcgan/<ts>/latest.ckpt --dst gen.pt2
    python -m jckx_torch panel --seeds 0,1 -m DCGAN --dataset synthetic -e 1
    python -m jckx_torch finetune --dataset cifar100 -e 300

    python -m jckx_torch plan -m DCGAN -b 128 --devices 8

Each command keeps its own module path too (``python -m jckx_torch.serve``,
``python -m jckx_torch.metrics.inception_train``, ``python -m
jckx_torch.plan``). Every jckx command has its counterpart here.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": "train DCGAN or CGAN, or score a run with -t 1 (the flags of main.py, plus --device)",
    "evaluate": "FID / IS / intra-FID (+ KID, PRDC) of a checkpoint, the trainers' eval protocol",
    "serve": "generate from a checkpoint or a sealed .pt2 / run the HTTP daemon",
    "export": "ship a sealed torch.export sampler (.pt2)",
    "convert": "convert a reference .pt <-> the port's checkpoint",
    "inspect": "describe a checkpoint, .pt, .pt2 or .jaxexp without touching the card",
    "doctor": "environment readiness check: the card, its link, the kernel build",
    "panel": "train one config across N seeds, one quality verdict",
    "finetune": "fine-tune the InceptionV3 metric backbone (loss_bset.npz for --metric_backbone)",
    "plan": "capacity planner: one rank's step FLOPs, bytes, memory, collectives vs H100 floors",
}


def _usage() -> str:
    rows = "\n".join(f"  {k:<9} {v}" for k, v in _COMMANDS.items())
    return (f"usage: python -m jckx_torch <command> [args...]\n\ncommands:\n{rows}"
            f"\n\n<command> -h shows that command's flags")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    if cmd == "train":
        from jckx_torch.train.main import main as train_main

        train_main(rest)
        return 0
    if cmd == "evaluate":
        from jckx_torch.evaluate import main as evaluate_main

        evaluate_main(rest)
        return 0
    if cmd == "serve":
        from jckx_torch.serve import get_args, main as serve_main

        serve_main(get_args(rest))
        return 0
    if cmd == "finetune":
        from jckx_torch.metrics.inception_train import main as finetune_main

        return finetune_main(rest)
    from importlib import import_module

    return import_module(f"jckx_torch.{cmd}").main(rest)


if __name__ == "__main__":
    raise SystemExit(main())
