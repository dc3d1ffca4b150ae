"""Seed panels: the same training config across N seeds, one verdict —
port of ``jckx/panel.py``.

    python -m jckx_torch panel --seeds 12345,777 -m CGAN --dataset cifar100 -e 100
    python -m jckx_torch panel --seeds 0,1 -m DCGAN --sweep lr_schedule=constant,cosine

Short-budget GAN quality is seed-sensitive, so a single-seed quality claim
is noise; a panel runs ``python -m jckx_torch train`` once per seed into
``save/<model>/<panel>/seed_<S>/`` and aggregates each run's eval
trajectory (``metrics.jsonl``) into one JSON verdict: per seed the best
FID / IS / intra-FID (and KID / precision / recall / density / coverage
with ``--extra_metrics 1``) and the median ``images_per_sec`` /
``step_ms`` over its launches, each session's first launch dropped (the
trainer writes a ``session_start`` record at every (re)launch); across
seeds min / median / max and relative spread.

Every flag the panel does not own is forwarded to the trainer as it is
(``--device`` among them, so ``--device cpu`` trains every seed on the
CPU). Re-running the same ``--panel_name`` resumes: a seed whose run dir
holds ``latest.ckpt`` gets ``--resume``. ``--sweep FLAG=v1,v2``
(repeatable; the cartesian product) runs the whole panel per variant into
``<panel>/<flag-v>/seed_<S>/`` and reports one aggregate per variant.

Prints one JSON line and writes ``panel.json`` (atomically) in the panel
dir. Exit 0 only when every run finished and produced eval records; 143
when SIGTERM stopped the panel (rerun to resume).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from datetime import datetime

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# metric -> better-direction; every other metrics.jsonl scalar is telemetry
BEST_OF = {"fid": min, "is": max, "intra_fid": min,
           "kid": min, "precision": max, "recall": max,
           "density": max, "coverage": max}

# per-launch telemetry scalars summarized as a per-run median (gan_trainer
# logs one record per launch; each session's first launch folds the CUDA
# context, cuDNN's algorithm search and the allocator's warm-up into its wall
# time, so collect() drops the first record after every session_start
# marker — falling back to dropping the last-seen one for logs without a
# marker — so resumed runs aggregate fairly)
TELEMETRY_MEDIANS = ("images_per_sec", "step_ms")


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])


def get_args(argv=None):
    # long options only + allow_abbrev=False: a short -m here would glue-match
    # the trainer's -mlr/-milr, and abbreviation would swallow a forwarded --seed
    # into --seeds — both must land in `rest` (or be rejected) instead
    p = argparse.ArgumentParser(
        description="jckx_torch seed panel (unknown flags forward to the trainer)",
        allow_abbrev=False)
    p.add_argument("--seeds", required=True,
                   help="comma-separated ints, e.g. 12345,777,20260819")
    p.add_argument("--model", default="",
                   help="model family DCGAN/CGAN (or pass -m in the "
                        "forwarded flags)")
    p.add_argument("--save_root", default="./save", help="forwarded")
    p.add_argument("--panel_name", default="",
                   help="panel run-dir name under save/<model>/ "
                        "(default panel_<timestamp>; reuse to resume)")
    p.add_argument("--sweep", action="append", default=[],
                   help='FLAG=v1,v2 — run every value as a variant '
                        '(repeatable; variants are the cartesian product), '
                        'e.g. --sweep lr_schedule=constant,cosine (dashes '
                        'optional: argparse would eat a dashed value, so '
                        'spell that form --sweep=--lr_schedule=...)')
    ns, rest = p.parse_known_args(argv)
    seeds = []
    for tok in ns.seeds.split(","):
        tok = tok.strip()
        if tok:
            seeds.append(int(tok))
    if not seeds:
        raise SystemExit("--seeds: need at least one integer seed")
    if len(set(seeds)) != len(seeds):
        raise SystemExit(f"--seeds: duplicate seed in {seeds}")
    ns.seed_list = seeds

    def _managed(tok: str) -> bool:
        # catch every spelling the trainer's argparse would accept for the
        # panel-managed flags: exact, '=value', and unambiguous long-option
        # abbreviations ('--seed=5', '--model_p x'). A missed spelling would
        # ride in `rest` AFTER the panel's own '--seed S' and last-wins
        # argparse would train every child with the same user seed — the
        # panel would then report near-zero spread for a config it never
        # actually varied.
        head = tok.split("=", 1)[0]
        if head == "-pm":
            return True
        if not head.startswith("--") or len(head) <= 3:
            return False
        return any(flag.startswith(head)
                   for flag in ("--seed", "--model_path", "--save_root"))

    bad = [a for a in rest if _managed(a)]
    if bad:
        raise SystemExit(f"--seed/-pm/--model_path/--save_root are "
                         f"panel-managed; don't pass them (got {bad})")

    # --sweep FLAG=v1,v2 → variant axes; cartesian product across axes
    sweeps = []
    for spec in ns.sweep:
        flag, sep, vals_s = spec.partition("=")
        vals = [v.strip() for v in vals_s.split(",") if v.strip()]
        if not sep or not flag or len(vals) < 2:
            raise SystemExit(
                f'--sweep expects FLAG=v1,v2[,...] with >=2 values, '
                f'got {spec!r}')
        if not flag.startswith("-"):
            flag = "--" + flag  # dashless convenience (use the long name)
        if _managed(flag) or flag == "-m":
            # -m/--model changes the family and with it the panel's own
            # save/<model>/ collection root — a swept value would divorce
            # the child's output dir from where collect() reads
            raise SystemExit(f"--sweep {flag}: panel-managed flags cannot "
                             f"be swept")
        if any(a == flag or a.startswith(flag + "=") for a in rest):
            raise SystemExit(
                f"--sweep {flag}: also passed as a forwarded flag — a fixed "
                f"value would silently override every variant (last-wins)")
        if any(f == flag for f, _ in sweeps):
            raise SystemExit(f"--sweep {flag}: duplicate sweep axis")
        sweeps.append((flag, vals))
    import itertools

    ns.variant_list = [tuple(pairs) for pairs in itertools.product(
        *[[(flag, v) for v in vals] for flag, vals in sweeps])] or [()]
    ns.model_in_rest = False
    if not ns.model:
        for i, a in enumerate(rest[:-1]):
            if a == "-m":
                ns.model, ns.model_in_rest = rest[i + 1], True
    if not ns.model:
        raise SystemExit("panel needs --model (or -m in the forwarded flags)")
    if not ns.panel_name:
        ns.panel_name = "panel_" + datetime.now().strftime("%Y%m%d_%H%M%S")
    return ns, rest


def variant_slug(variant) -> str:
    """(('--lr_schedule','cosine'),) → 'lr_schedule-cosine'; () → ''.

    Values that need sanitizing (os.sep) additionally carry a short content
    hash: without it two distinct sweep values ('runs/x' vs 'runs-x') would
    collide into ONE slug — merging their run dirs and silently cross-
    resuming the second variant from the first's checkpoint."""
    parts = []
    for flag, val in variant:
        val = str(val)
        safe = val.replace(os.sep, "-")
        if safe != val:
            import hashlib
            safe += "-" + hashlib.sha1(val.encode()).hexdigest()[:6]
        parts.append(f"{flag.lstrip('-')}-{safe}")
    return "_".join(parts)


def child_argv(seed: int, ns, rest, variant=()) -> list:
    """argv for one (variant, seed) training subprocess (the trainer's flags)."""
    run_dir = seed_run_dir(seed, ns, variant)
    model_flags = [] if ns.model_in_rest else ["-m", ns.model]
    slug = variant_slug(variant)
    pm = (f"{ns.panel_name}/{slug}/seed_{seed}" if slug
          else f"{ns.panel_name}/seed_{seed}")
    argv = [sys.executable, "-m", "jckx_torch", "train", *model_flags, "--save_root", ns.save_root,
            "-pm", pm, "--seed", str(seed)] + list(rest)
    for flag, val in variant:
        argv += [flag, val]
    if ("--resume" not in rest
            and os.path.exists(os.path.join(run_dir, "latest.ckpt"))):
        argv.append("--resume")  # interrupted panel rerun continues the run
    return argv


def seed_run_dir(seed: int, ns, variant=()) -> str:
    slug = variant_slug(variant)
    parts = [ns.save_root, ns.model.lower(), ns.panel_name]
    if slug:
        parts.append(slug)
    return os.path.join(*parts, f"seed_{seed}")


def run_child(argv: list) -> int:
    """Launch one seed's run; module-level so tests can run in-process."""
    return subprocess.call(argv, cwd=_REPO_ROOT)


def collect(run_dir: str) -> dict:
    """Best-per-metric of one run's eval trajectory (metrics.jsonl)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    out = {"run_dir": run_dir, "evals": 0, "last_step": None}
    if not os.path.exists(path):
        out["error"] = "no metrics.jsonl"
        return out
    telemetry = {name: [] for name in TELEMETRY_MEDIANS}
    # Every process session's FIRST launch folds the warm-up into its
    # wall time, so it is dropped per session: the trainer writes a
    # session_start marker at every (re)launch, so a preempted-and-resumed
    # seed doesn't keep later sessions' warm-up-inflated launches in its
    # median. dropped_last keeps the most recent dropped value as a
    # fallback for degenerate runs whose every session had a single launch.
    drop_next = set(TELEMETRY_MEDIANS)  # file start = first session
    dropped_last = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line of a killed run
            if rec.get("event") == "session_start":
                drop_next = set(TELEMETRY_MEDIANS)
                continue
            if "step" in rec:
                out["last_step"] = rec["step"]
            if "fid" not in rec:
                # train-telemetry record, not an eval boundary
                for name in TELEMETRY_MEDIANS:
                    if rec.get(name) is not None:
                        if name in drop_next:
                            drop_next.discard(name)
                            dropped_last[name] = rec[name]
                        else:
                            telemetry[name].append(rec[name])
                continue
            out["evals"] += 1
            for name, better in BEST_OF.items():
                v = rec.get(name)
                if v is None:
                    continue
                key = f"best_{name}"
                out[key] = v if key not in out else better(out[key], v)
    for name, vals in telemetry.items():
        if not vals and name in dropped_last:
            vals = [dropped_last[name]]  # better a warm-up-tainted sample
        if vals:
            out[f"median_{name}"] = round(_median(vals), 3)
    if out["evals"] == 0:
        out["error"] = "no eval records (did the run reach an eval boundary?)"
    return out


def aggregate(per_seed: dict) -> dict:
    """min/median/max + relative spread for every best_* all seeds share."""
    rows = list(per_seed.values())
    if not rows:
        return {}
    shared = set(rows[0]) if rows else set()
    for r in rows[1:]:
        shared &= set(r)
    agg = {}
    summarized = tuple(f"median_{n}" for n in TELEMETRY_MEDIANS)
    for key in sorted(k for k in shared
                      if k.startswith("best_") or k in summarized):
        vals = sorted(r[key] for r in rows)
        med = _median(vals)
        agg[key] = {"min": vals[0], "median": med, "max": vals[-1],
                    "rel_spread": ((vals[-1] - vals[0]) / abs(med)
                                   if med else None)}
    return agg


def main(argv=None) -> int:
    ns, rest = get_args(argv)
    panel_dir = os.path.join(ns.save_root, ns.model.lower(), ns.panel_name)
    exits = {}
    t0 = time.time()
    # Graceful preemption mirrors the trainer's (gan_trainer.train): on
    # SIGTERM the RUNNING child checkpoints at its next launch boundary and
    # exits 143 (same process group) — the panel must then STOP launching
    # seeds, not march on; rerunning the same --panel_name resumes.
    preempted = threading.Event()
    prev_term, own_handler = None, False
    if threading.current_thread() is threading.main_thread():
        try:
            prev_term = signal.signal(
                signal.SIGTERM, lambda signum, frame: preempted.set())
            own_handler = True
        except (ValueError, OSError):
            pass
    variants = {}  # slug -> {"variant", "per_seed", "aggregate"}
    try:
        for variant in ns.variant_list:
            slug = variant_slug(variant)
            per_seed = variants.setdefault(
                slug or "base",
                {"variant": dict(variant), "per_seed": {}})["per_seed"]
            for seed in ns.seed_list:
                vkey = (slug, seed)
                if preempted.is_set():
                    per_seed[str(seed)] = {"error": "not run (panel preempted)"}
                    exits[vkey] = None
                    continue
                argv_s = child_argv(seed, ns, rest, variant)
                print(f"[panel] {slug + ' ' if slug else ''}seed {seed}: "
                      f"{' '.join(argv_s[2:])}", file=sys.stderr)
                exits[vkey] = run_child(argv_s)
                per_seed[str(seed)] = collect(seed_run_dir(seed, ns, variant))
                per_seed[str(seed)]["exit_code"] = exits[vkey]
                if exits[vkey] in (143, -signal.SIGTERM):
                    # 143: child handled SIGTERM and checkpointed; -15: the
                    # child was killed by a raw SIGTERM before its handler
                    # was up (or only the child pid was signaled) — either
                    # way the panel is being preempted: stop launching.
                    preempted.set()
    finally:
        if own_handler:
            signal.signal(signal.SIGTERM,
                          prev_term if prev_term is not None else signal.SIG_DFL)
    for row in variants.values():
        row["aggregate"] = aggregate(row["per_seed"])
    result = {
        "panel": ns.panel_name, "model": ns.model,
        "seeds": ns.seed_list, "wall_s": round(time.time() - t0, 1),
        "preempted": preempted.is_set(),
    }
    if len(ns.variant_list) == 1 and not ns.variant_list[0]:
        # no sweep: keep the flat seed-panel shape
        result["per_seed"] = variants["base"]["per_seed"]
        result["aggregate"] = variants["base"]["aggregate"]
    else:
        result["variants"] = variants
    ok = all(c == 0 for c in exits.values()) and not any(
        "error" in r
        for row in variants.values() for r in row["per_seed"].values())
    result["ok"] = ok
    os.makedirs(panel_dir, exist_ok=True)
    tmp = os.path.join(panel_dir, "panel.json.tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, os.path.join(panel_dir, "panel.json"))
    print(json.dumps(result))
    if preempted.is_set():
        return 143  # conventional SIGTERM code: resumable, not failed
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
