"""``python -m jckx_torch <command> [args...]`` — port of ``jckx/__main__.py``
for the commands ported so far:

    python -m jckx_torch train -m DCGAN --dataset synthetic -e 1

Serving keeps its own module path: ``python -m jckx_torch.serve``.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": "train DCGAN (the flags of main.py, plus --device)",
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
    print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
