"""``python -m jckx_torch <command> [args...]`` — port of ``jckx/__main__.py``
for the commands ported so far:

    python -m jckx_torch train -m CGAN --dataset synthetic -e 1
    python -m jckx_torch evaluate --ckpt save/cgan/<ts>/latest.ckpt

Serving keeps its own module path: ``python -m jckx_torch.serve``.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": "train DCGAN or CGAN, or score a run with -t 1 (the flags of main.py, plus --device)",
    "evaluate": "FID / IS / intra-FID of a checkpoint, the trainers' eval protocol",
}


def _usage() -> str:
    rows = "\n".join(f"  {k:<8} {v}" for k, v in _COMMANDS.items())
    return (f"usage: python -m jckx_torch <command> [args...]\n\ncommands:\n{rows}"
            f"\n\n<command> -h shows that command's flags")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "train":
        from jckx_torch.train.main import main as train_main

        train_main(rest)
        return 0
    if cmd == "evaluate":
        from jckx_torch.evaluate import main as evaluate_main

        evaluate_main(rest)
        return 0
    print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
