"""The training entry point — port of the repo-root ``main.py``.

    python -m jckx_torch train [flags of main.py] [--device cpu]

Flow as the reference's (main.py:64-96): parse the flags → the run dir
``save/<model>/<ts>`` (its ``config.json`` is what ``--resume`` inherits)
→ the singleton logger → the data → G and D drawn from ``--seed`` → the
trainer → ``train()``. A run cut by SIGTERM exits 143. Training runs on
the card unless ``--device`` names another device.

Not ported yet: ``-m CGAN`` (ROADMAP A8) and ``-t 1``, scoring a run
(ROADMAP A9); both exit nonzero, naming their item.
"""

from __future__ import annotations

import os
import sys
from datetime import datetime

import torch

from jckx_torch.configs import Config, check_ported, get_arg_parse
from jckx_torch.data.pipeline import DCGANDataPreprocessor
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models.dcgan import Discriminator, Generator
from jckx_torch.train.gan_trainer import DCGANTrainer
from jckx_torch.train.state import geometry
from jckx_torch.utils.device import resolve_device


def run(cfg: Config, metrics=None) -> DCGANTrainer:
    """Train as the CLI does; → the trainer (its ``preempted`` says whether
    SIGTERM cut the run). ``metrics`` replaces the InceptionV3 engine."""
    check_ported(cfg)
    if cfg.test:
        raise SystemExit("-t/--test (score a run's checkpoint) is not ported yet "
                         "(ROADMAP.md A9: jckx_torch/evaluate.py and -t 1)")
    if cfg.model != "DCGAN":
        raise SystemExit(f"-m {cfg.model} is not ported yet (ROADMAP.md A8: CGAN)")
    device = resolve_device(cfg.device)
    ts = cfg.model_path or datetime.now().strftime("%Y%m%d_%H%M%S")
    cfg.save_path = os.path.join(cfg.save_root, cfg.model.lower(), ts)
    os.makedirs(cfg.save_path, exist_ok=True)
    tmp = os.path.join(cfg.save_path, "config.json.tmp")
    with open(tmp, "w") as f:
        f.write(cfg.to_json())
    os.replace(tmp, os.path.join(cfg.save_path, "config.json"))

    logger = MainLogger(cfg)
    if getattr(cfg, "inherited_from", None):
        logger.debug(f"config inherited from {cfg.inherited_from} (flags given now override)")
    logger.debug(f"config: {cfg.to_json()}")
    logger.debug(f"device: {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    data_pre = DCGANDataPreprocessor(cfg)
    geo = geometry(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    G, D = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
    trainer = DCGANTrainer(cfg, G, D, data_pre, metrics=metrics)
    trainer.train()
    return trainer


def main(argv=None) -> DCGANTrainer:
    trainer = run(get_arg_parse(sys.argv[1:] if argv is None else argv))
    if trainer.preempted:
        raise SystemExit(143)  # "terminated by SIGTERM": resumable, not complete
    return trainer


if __name__ == "__main__":
    main()
