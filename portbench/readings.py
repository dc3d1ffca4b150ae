"""The readings that a cell's limits are set from, at the cell's own size:
the program's own (``--program``: the cell run as the benchmark runs it,
seed after seed in one process, its compared numbers printed), the control
(the plain reference computed in float8, the precision below the
configuration's bfloat16, put in the program's place) and, for
training cells, a planted fault (``half``: every loss's mean over the
first half of the batch), each judged against the float32 reference as
the benchmark judges the program. For training cells ``--from_step 1``
puts the control or the fault in the replayed steps alone (the first step
sound).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--program | --fault half] [--from_step 1] [--seconds 20]

Prints one JSON line per seed. Not run by the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import core  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", default="")
    p.add_argument("--from_step", type=int, default=0)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            ctx = core.Context(args.workload, seed, args.seconds, False, "cuda:0",
                               time.perf_counter())
            try:
                out = core.traffic(ctx.workload["traffic"]).run(ctx)
            finally:
                ctx.close()
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": "program",
                              "answered": out.answered, "failed": out.failed, **out.numbers,
                              **out.e2e, "setup_s": ctx.setup_s}), flush=True)
            continue
        ctx = core.Context(args.workload, seed, args.seconds, False, "cuda:0",
                           time.perf_counter())
        try:
            mod = core.traffic(ctx.workload["traffic"])
            precision = "f32" if args.fault else "fp8"
            extra = {"from_step": args.from_step} if args.from_step else {}
            nums = mod.readings(ctx, precision, args.fault, **extra)
        finally:
            ctx.close()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": args.fault or "control fp8",
                          "from_step": args.from_step, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
