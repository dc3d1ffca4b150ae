"""The benchmark of jckx_torch on NVIDIA GPUs (see README.md).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without as many CUDA devices as the cell asks for, or when a JAX
module is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here: the process's first statement

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("USE_FLAX", "0")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    from portbench import core

    wl, _ = core.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    line, err = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T0, spec)
    found = core.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in the measured process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for text in err:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
