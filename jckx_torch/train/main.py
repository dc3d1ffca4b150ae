"""The training entry point — port of the repo-root ``main.py``.

    python -m jckx_torch train [-m DCGAN|CGAN] [flags of main.py] [--device cpu]
    python -m jckx_torch train -t 1 -pm <ts> [-m ...]

Flow as the reference's (main.py:64-96): parse the flags → the run dir
``save/<model>/<ts>`` (its ``config.json`` is what ``--resume`` and ``-t``
inherit) → the singleton logger → the data → G and D drawn from ``--seed``
→ the trainer → ``train()``. A run cut by SIGTERM exits 143. Training runs
on the card unless ``--device`` names another device.

``--sanitize`` runs the data set-up, the model build and ``train()`` under
``torch.autograd.detect_anomaly(check_nan=True)``, jckx's ``jax_debug_nans``
(``main.py:91-92``) and the reference's always-on ``set_detect_anomaly``:
a backward function that returns NaN raises, naming itself and the forward
that made it. The context manager restores the global flag when the run
ends. The trainer's ``nan_guard`` keeps catching non-finite telemetry.

``--profile_dir <dir>`` records the same span with ``torch.profiler``
(activities: the CPU, and CUDA on the card), where jckx wraps it in
``jax.profiler.start_trace`` / ``stop_trace`` (``main.py:145-166``). When
the run returns, the trace is written into ``<dir>`` as a Chrome trace,
``jckx_torch_<time>.pt.trace.json`` (``chrome://tracing``, Perfetto,
TensorBoard's PyTorch profiler plug-in): a different format from jckx's
XPlane ``.xplane.pb``, by design.

Data parallel (``--mesh_shape N``, ``--multihost``; jckx ``main.py:81-90``):
one process per GPU, launched by ``torchrun --nproc_per_node N -m jckx_torch
train --mesh_shape N --multihost``. ``run`` brings the process group up
from the ``env://`` variables (a group the caller already initialized is
kept), builds the process mesh, and gives every rank the lead's run dir
name; rank 0 alone writes ``config.json``, the log and the artifacts. A
mesh larger than the world raises, naming ``torchrun --nproc_per_node``.
A model axis (``--mesh_shape D,M --mesh_axes data,model --model_axis_mode
tp|spatial``) runs on D·M ranks: ``torchrun --nproc_per_node
D·M -m jckx_torch train --mesh_shape D,M --mesh_axes data,model
--model_axis_mode tp --multihost``.

``-t 1 -pm <ts>`` trains nothing: it scores the run's ``latest.ckpt``
through ``jckx_torch.evaluate`` with the run's own seed, data, dtype and
eval sizes, so it reproduces the run's last logged eval (``main.py:32-74``),
and prints the JSON line.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from datetime import datetime

import torch

from jckx_torch.configs import Config, check_ported, get_arg_parse
from jckx_torch.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models.cgan import CDiscriminator, CGenerator
from jckx_torch.models.dcgan import Discriminator, Generator
from jckx_torch.parallel.mesh import process_mesh
from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer
from jckx_torch.train.state import geometry
from jckx_torch.utils.device import multihost_barrier, resolve_device


def run_test_mode(cfg: Config, metrics=None) -> dict:
    """``-t 1``: score ``<save_root>/<model>/<ts>/latest.ckpt`` → the
    result dict, printed as one JSON line. Refuses before it writes
    anything when ``-pm`` is missing or names a run without a checkpoint."""
    if not cfg.model_path:
        raise SystemExit("-t/--test needs -pm/--model_path (which run to score): "
                         "e.g. python -m jckx_torch train -m DCGAN -pm 20260816_073320 -t 1")
    run_dir = os.path.join(cfg.save_root, cfg.model.lower(), cfg.model_path)
    ckpt = os.path.join(run_dir, "latest.ckpt")
    if not os.path.exists(ckpt):
        have = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
        raise SystemExit(f"-t/--test: no latest.ckpt under {run_dir} "
                         f"(dir contains: {have or 'nothing'})")
    from jckx_torch.evaluate import evaluate, get_args

    argv = ["--ckpt", ckpt, "--dataset", cfg.dataset, "--data_dir", cfg.data_dir,
            "--data_path", cfg.data_path, "--synthetic_size", str(cfg.synthetic_size),
            "--seed", str(cfg.seed), "--compute_dtype", cfg.compute_dtype,
            "--sample_count", str(cfg.sample_count), "--eval_batch_size", str(cfg.eval_batch_size),
            "--metric_backbone", cfg.metric_backbone, "--save_root", cfg.save_root,
            "--device", cfg.device, "--eval_fast_stem", str(cfg.eval_fast_stem)]
    if cfg.extra_metrics:  # the run logged KID and PRDC at its evals (main.py:63-69)
        argv += ["--kid", "1", "--prdc", "1"]
    result = evaluate(get_args(argv), metrics=metrics)
    print(json.dumps(result))
    return result


@contextlib.contextmanager
def profile_trace(profile_dir: str, device: torch.device, logger=None):
    """``torch.profiler`` over the body; on a normal exit its Chrome trace
    is written into ``profile_dir``. → yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(profile_dir,
                        f"jckx_torch_{datetime.now().strftime('%Y%m%d_%H%M%S')}.pt.trace.json")
    prof.export_chrome_trace(path)
    if logger is not None:
        logger.debug(f"profile trace written to {path}")


def run_modes(cfg: Config, device: torch.device, logger=None) -> contextlib.ExitStack:
    """The context of a training run: anomaly detection with
    ``--sanitize``, the profiler with ``--profile_dir``."""
    stack = contextlib.ExitStack()
    if cfg.sanitize:
        stack.enter_context(torch.autograd.detect_anomaly(check_nan=True))
    if cfg.profile_dir:
        stack.enter_context(profile_trace(cfg.profile_dir, device, logger))
    return stack


def run(cfg: Config, metrics=None):
    """Train as the CLI does → the trainer (its ``preempted`` says whether
    SIGTERM cut the run); with ``-t`` score the run instead → the result
    dict. ``metrics`` replaces the InceptionV3 engine."""
    check_ported(cfg)
    if cfg.test:
        return run_test_mode(cfg, metrics)
    device = resolve_device(cfg.device)
    mesh = process_mesh(cfg.mesh_shape, cfg.mesh_axes, cfg.multihost, device, MainLogger(),
                        model_axis=True)
    ts = cfg.model_path or datetime.now().strftime("%Y%m%d_%H%M%S")
    if mesh is not None:
        ts = mesh.broadcast_object(ts)  # the lead's run dir on every rank
    cfg.save_path = os.path.join(cfg.save_root, cfg.model.lower(), ts)
    if mesh is None or mesh.lead:
        os.makedirs(cfg.save_path, exist_ok=True)
        tmp = os.path.join(cfg.save_path, "config.json.tmp")
        with open(tmp, "w") as f:
            f.write(cfg.to_json())
        os.replace(tmp, os.path.join(cfg.save_path, "config.json"))
    else:
        cfg.log_file = 0  # rank 0 alone writes the log

    logger = MainLogger(cfg)
    if getattr(cfg, "inherited_from", None):
        logger.debug(f"config inherited from {cfg.inherited_from} (flags given now override)")
    logger.debug(f"config: {cfg.to_json()}")
    logger.debug(f"device: {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                 + (f", rank {mesh.rank} of mesh {mesh.shape}" if mesh is not None else ""))

    geo = geometry(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    with run_modes(cfg, device, logger):
        if cfg.model == "CGAN":
            data_pre = CGANDataPreprocessor(cfg)
            cfg.num_classes = data_pre.num_classes
            G = CGenerator(geo, cfg.num_classes, gen=gen)
            D = CDiscriminator(geo, cfg.num_classes, gen=gen)
            trainer = CGANTrainer(cfg, G, D, data_pre, metrics=metrics, mesh=mesh)
        else:
            data_pre = DCGANDataPreprocessor(cfg)
            G, D = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
            trainer = DCGANTrainer(cfg, G, D, data_pre, metrics=metrics, mesh=mesh)
        trainer.train()
    multihost_barrier("train done", logger)
    return trainer


def main(argv=None):
    """→ the trainer, or with ``-t`` the result dict."""
    cfg = get_arg_parse(sys.argv[1:] if argv is None else argv)
    out = run(cfg)
    if not cfg.test and out.preempted:
        raise SystemExit(143)  # "terminated by SIGTERM": resumable, not complete
    return out


if __name__ == "__main__":
    main()
