"""Configuration — port of ``jckx/configs.py``.

One dataclass holds the reference's 11 CLI flags with their names and
defaults (``main.py:40-61``; ``-mlr 0.1`` included), the trainer constants
the reference hard-codes (lambda_gp 10, Adam betas (0.5, 0.999), labels
0.9 / 0.1, instance noise 0.1, eval every 500, log every 100), and the
fields of ``jckx.configs.Config`` that the port's trainers read.

The port adds ``--device`` (default ``cuda``, ``cuda:{LOCAL_RANK}`` under
``torchrun``; ``cpu`` runs the plain PyTorch path).

The mesh is jckx's (``parallel/mesh.py``): ``--mesh_shape N`` trains on N
ranks of a process group on the data axis, and ``--mesh_shape D,M
--mesh_axes data,model`` on D·M ranks, the ``model`` axis sharding each
layer's output channels (``--model_axis_mode tp``, leaves of at least
``--tp_min_dim``) or the activations' height (``spatial``, with
``--spatial_replicate_grads 0|1``); one process per GPU, brought up from
torch's ``env://`` variables when ``--multihost`` is given or the mesh has
more than one rank (``torchrun --nproc_per_node D·M -m jckx_torch train
--mesh_shape D,M --mesh_axes data,model --multihost``).

The data planes are jckx's (``:115-124``): ``--data_placement hbm`` keeps
the uint8 set on the device, ``stream`` gathers each launch's rows on the
host with ``-w/--num_worker`` C++ gather threads and uploads them as one
pinned slab, and ``auto`` (the default) streams a set larger than
``--hbm_data_budget`` bytes (default 4 GiB). ``--dataset folder`` reads a
directory of images (``--data_path``) at ``--image_size``.

``--resume`` and ``-t`` inherit the run's stored ``config.json`` for every
flag not given now, as in ``jckx``.

The train step's modes are jckx's: ``--fused_prop 1`` (one fake-side D
forward serves both players, ``train/steps.py``), ``--remat none|g|d|both``
(activation checkpointing of G and / or D), ``--sanitize`` (the run under
``torch.autograd.detect_anomaly``) and ``--profile_dir`` (a
``torch.profiler`` Chrome trace of the run, ``train/main.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from typing import Optional

from jckx_torch.parallel.mesh import check_mesh, parse_mesh_axes, parse_mesh_shape

RANDOMSEED = 12345  # the reference's global seed (change_randomseed.py:1)
MODELS = ("DCGAN", "CGAN")


@dataclass
class Config:
    # --- reference CLI flags (names/defaults preserved, main.py:40-61) ---
    test: int = 0                      # -t
    model_path: str = ""               # -pm  run-dir name to reuse
    log_file: int = 1                  # -lf
    model: str = "DCGAN"               # -m
    num_worker: int = 0                # -w   gather threads of the streaming plane
    batch_size: int = 128              # -b
    epoch: int = 100                   # -e
    max_learning_rate: float = 0.1     # -mlr (Adam lr, dcgan_trainer.py:61)
    min_learning_rate: float = 1e-4    # -milr (cosine floor under --lr_schedule)
    weight_decay: float = 5e-4         # -wd  (parsed but unused in the reference)
    nesterov: int = 1                  # -snt (parsed but unused in the reference)

    # --- promoted trainer constants (reference values as defaults) ---
    lambda_gp: float = 10.0
    adam_beta1: float = 0.5
    adam_beta2: float = 0.999
    label_real: float = 0.9
    label_fake: float = 0.1
    instance_noise: float = 0.1
    eval_every: int = 500
    log_every: int = 100
    lr_schedule: str = "constant"      # "cosine": -mlr → -milr over lr_decay_steps
    lr_decay_steps: int = 0            # 0 = the trainer's epochs × steps/epoch
    gp_in_d_grad: bool = True          # False = the reference DCGAN quirk

    # --- model / data geometry ---
    base_width: int = 64
    z_dim: int = 100
    num_classes: int = 100
    image_size: int = 64
    channels: int = 3
    dataset: str = "cifar100"          # cifar100 | cifar10 | mnist | synthetic | npz | folder
    data_dir: str = "./data"
    data_path: str = ""                # the .npz file / image directory of npz / folder
    synthetic_size: int = 0            # 0 = 4096

    seed: int = RANDOMSEED

    # --- the port's own ---
    device: str = "cuda"

    compute_dtype: str = "bfloat16"
    ema_decay: float = 0.0
    eval_batch_size: int = 256
    sample_count: int = 64
    metric_backbone: str = ""
    nan_guard: bool = True
    preempt_save: bool = True
    save_root: str = "./save"
    resume: bool = False
    init_from_torch: str = ""
    eval_fast_stem: int = 0            # 1 = the space-to-depth InceptionV3 stem in the evals
    extra_metrics: int = 0             # 1 = KID + precision/recall/density/coverage at evals

    # --- the train step's modes ---
    remat: str = "none"                # none | g | d | both
    fused_prop: int = 0
    sanitize: bool = False             # torch.autograd.detect_anomaly over the run
    profile_dir: str = ""              # torch.profiler Chrome trace dir ('' = off)

    # --- the data plane: "hbm" resident, "stream" host slabs, "auto" by the budget ---
    data_placement: str = "auto"
    hbm_data_budget: int = 4 << 30

    # --- the mesh: data axis, and a model axis of tp or spatial ---
    mesh_shape: str = ""               # "N": N ranks on the data axis ('' = one process)
    mesh_axes: str = "data"
    model_axis_mode: str = "tp"
    tp_min_dim: int = 128
    spatial_replicate_grads: int = 1
    multihost: bool = False            # bring the process group up from the env:// variables

    save_path: str = ""                # set by the entry point / trainer

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def check_ported(cfg: Config) -> None:
    """Raise ``SystemExit`` for a mesh or a model-axis knob that ``train``
    cannot run: a malformed mesh (``check_mesh``), a ``--tp_min_dim`` below
    1, a ``--spatial_replicate_grads`` other than 0 or 1."""
    bad = []
    try:
        check_mesh(parse_mesh_shape(cfg.mesh_shape), parse_mesh_axes(cfg.mesh_axes),
                   model_axis=True)
    except ValueError as e:
        bad.append(f"--mesh_shape {cfg.mesh_shape!r} --mesh_axes {cfg.mesh_axes!r}: {e}")
    if cfg.model_axis_mode not in ("tp", "spatial"):
        bad.append(f"--model_axis_mode {cfg.model_axis_mode!r}: expected tp or spatial")
    if cfg.tp_min_dim < 1:
        bad.append(f"--tp_min_dim {cfg.tp_min_dim}: must be at least 1")
    if cfg.spatial_replicate_grads not in (0, 1):
        bad.append(f"--spatial_replicate_grads {cfg.spatial_replicate_grads}: expected 0 or 1")
    if bad:
        raise SystemExit("jckx_torch: " + "; ".join(bad))


def _explicit_dests(parser: argparse.ArgumentParser, argv: list) -> set:
    """Dest names of the options literally given on the command line: argv
    re-parsed with every default swapped for a sentinel (a token scan would
    miss attached spellings like ``-e200``)."""
    sentinel = object()
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a, _ in saved:
            a.default = sentinel
        ns = parser.parse_args(argv)
    finally:
        for a, default in saved:
            a.default = default
    return {a.dest for a, _ in saved
            if a.dest != "help" and getattr(ns, a.dest, sentinel) is not sentinel}


# fields a resumed run takes from its own command line, never from the stored config
_NO_INHERIT = {"test", "model_path", "resume", "save_root", "save_path",
               "log_file", "init_from_torch", "device", "profile_dir", "multihost"}
# jckx's config.json stores these parsed (None / a list); the port keeps jckx's flag strings
_MESH_FIELDS = ("mesh_shape", "mesh_axes")


def _inherit_run_config(cfg: Config, explicit: set) -> Optional[str]:
    """``--resume`` / ``-t``: adopt the run's stored ``config.json`` for every
    flag not given on this command line (a resume that forgets ``-mlr``
    would otherwise continue at the reference's lr 0.1). → the path read, or
    None when the run dir has no config.json."""
    cand = sorted(glob.glob(os.path.join(cfg.save_root, "*", cfg.model_path, "config.json")))
    if len(cand) > 1:
        fam = [c for c in cand
               if os.path.basename(os.path.dirname(os.path.dirname(c))) == cfg.model.lower()]
        if "model" not in explicit or len(fam) != 1:
            raise SystemExit(f"--resume/-t: run dir {cfg.model_path!r} exists under several "
                             f"model families ({cand}); pass -m to choose")
        cand = fam
    if not cand:
        return None
    with open(cand[0]) as f:
        stored = json.load(f)
    if "model" in explicit and stored.get("model", cfg.model) != cfg.model:
        raise SystemExit(f"--resume/-t: {cand[0]} records model {stored['model']} but "
                         f"-m {cfg.model} was passed")
    for field in dataclasses.fields(Config):
        if field.name in stored and field.name not in _NO_INHERIT | explicit:
            value = stored[field.name]
            if field.name in _MESH_FIELDS:
                value = "" if value is None else value
                value = ",".join(map(str, value)) if isinstance(value, list) else value
            setattr(cfg, field.name, value)
    return cand[0]


_INT_BOOLS = ("gp_in_d_grad", "nan_guard", "preempt_save")


def get_arg_parse(argv: Optional[list] = None) -> Config:
    """The CLI of ``jckx/configs.py:286-409``, plus ``--device``."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    d = Config()
    p = argparse.ArgumentParser(description="jckx_torch - DCGAN / CGAN on PyTorch/CUDA",
                                allow_abbrev=False)
    p.add_argument("-t", "--test", type=int, default=d.test, help="test mode")
    p.add_argument("-pm", "--model_path", type=str, default=d.model_path, help="run-dir name to reuse")
    p.add_argument("-lf", "--log_file", type=int, default=d.log_file, help="write log file 0/1")
    p.add_argument("-m", "--model", type=str, choices=MODELS, default=d.model, help="model family")
    p.add_argument("-w", "--num_worker", type=int, default=d.num_worker,
                   help="gather threads of the streaming data plane")
    p.add_argument("-b", "--batch_size", type=int, default=d.batch_size, help="batch size")
    p.add_argument("-e", "--epoch", type=int, default=d.epoch, help="epochs")
    p.add_argument("-mlr", "--max_learning_rate", type=float, default=d.max_learning_rate)
    p.add_argument("-milr", "--min_learning_rate", type=float, default=d.min_learning_rate)
    p.add_argument("-wd", "--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("-snt", "--nesterov", type=int, default=d.nesterov)

    p.add_argument("--dataset", type=str, default=d.dataset,
                   choices=["cifar100", "cifar10", "mnist", "synthetic", "npz", "folder"])
    for name in ("data_dir", "data_path", "metric_backbone", "save_root", "init_from_torch",
                 "device", "mesh_shape", "mesh_axes", "profile_dir"):
        p.add_argument(f"--{name}", type=str, default=getattr(d, name))
    for name in ("synthetic_size", "seed", "eval_every", "log_every", "sample_count",
                 "eval_batch_size", "lr_decay_steps", "image_size", "base_width",
                 "fused_prop", "eval_fast_stem", "extra_metrics", "tp_min_dim",
                 "spatial_replicate_grads", "hbm_data_budget"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("lambda_gp", "ema_decay"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    for name in _INT_BOOLS:
        p.add_argument(f"--{name}", type=int, default=int(getattr(d, name)))
    p.add_argument("--lr_schedule", type=str, default=d.lr_schedule, choices=["constant", "cosine"])
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", type=str, default=d.remat, choices=["none", "g", "d", "both"])
    p.add_argument("--model_axis_mode", type=str, default=d.model_axis_mode,
                   choices=["tp", "spatial"])
    p.add_argument("--data_placement", type=str, default=d.data_placement,
                   choices=["auto", "hbm", "stream"])
    for name in ("sanitize", "multihost", "resume"):
        p.add_argument(f"--{name}", action="store_true", default=getattr(d, name))

    ns = p.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)
                    if hasattr(ns, f.name)})
    for name in _INT_BOOLS:
        setattr(cfg, name, bool(getattr(ns, name)))
    cfg.inherited_from = None
    if cfg.model_path and (cfg.resume or cfg.test):
        cfg.inherited_from = _inherit_run_config(cfg, _explicit_dests(p, argv))
    if cfg.dataset in ("cifar10", "mnist"):
        cfg.num_classes = 10
    if cfg.dataset == "mnist":
        cfg.channels = 1
    return cfg
