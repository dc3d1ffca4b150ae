"""Write the jckx checkpoint fixture that jckx_torch reads without JAX.

    JAX_PLATFORMS=cpu python tests/data/jckx_ckpt/make_fixture.py [--out DIR]

It needs the JAX package (``jckx``, flax) and runs on the CPU. It trains
two tiny runs with jckx's own CLI config and trainer (``main.py``'s flow,
with a stub metrics engine in place of InceptionV3) and keeps what a user
would carry to the port:

- ``dcgan/run/``: a DCGAN run, 16², base width 8, ``--ema_decay 0.9``,
  ``latest.ckpt`` + its ``.json`` sidecar + the run's ``config.json``
  (so ``python -m jckx_torch train --resume -pm run`` continues it);
- ``cgan/run/``: a CGAN run on ``cifar10`` (K = 10), 16², base width 4
  (CGAN D's fc1 makes width 8 twice the size), the same three files;
- ``z.npy``: 16 latents, row i is ``jax.random.normal(PRNGKey(i),
  (z_dim,))``; ``cgan_labels.npy``: class ``i % 10`` for row i;
- ``dcgan_renders.npy``, ``cgan_renders.npy``: jckx's f32 renders of that
  batch of 16 through ``jckx.serve.GeneratorService``'s sampler (DCGAN:
  the EMA generator, what jckx serves), tanh images (16, 16, 16, 3).

Both runs use 64 synthetic rows, batch 16, one epoch of 4 steps, lr 2e-4,
f32, and evals after steps 2 and 4, so ``latest.ckpt`` is at step 4.
XLA runs on one device with its Eigen thread pool off, so a rerun on the
same host writes the same bytes. Another host may not: XLA's CPU code
generation follows the host's instruction set (AVX2, AVX-512), which
reorders float sums, and the checkpoints' and renders' last bits move
with it. ``config.json``'s paths are made relative.
``tests/test_torch_jckx_ckpt.py`` regenerates the fixture and compares it
with the committed files: names, configs and inputs exactly, the floats
within a stated number of f32 ulps.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                           "--xla_cpu_multi_thread_eigen=false")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

N_RENDER = 16
RUNS = {  # family: (flags, z_dim)
    "DCGAN": (["--dataset", "synthetic", "--base_width", "8", "--ema_decay", "0.9"], 16),
    "CGAN": (["--dataset", "cifar10", "--base_width", "4"], 16),
}
COMMON = ["--synthetic_size", "64", "-b", "16", "-e", "1", "--image_size", "16",
          "--compute_dtype", "float32", "-mlr", "2e-4", "--log_every", "2",
          "--eval_every", "4", "--log_file", "0", "-pm", "run"]


class StubMetrics:
    """Deterministic stand-in for the InceptionV3 engine (as jckx's
    tests/test_trainer.py uses)."""

    def __init__(self):
        self.calls = 0

    def inception_score(self, images=None, splits=10, logits=None):
        self.calls += 1
        return 1.0 + 0.1 * self.calls

    def extract_features(self, images):
        return np.random.RandomState(0).randn(len(images), 8).astype(np.float32)

    def fid(self, images_tanh=None, intra_fid=False, label=0, features=None):
        return 100.0 / self.calls

    def intra_fid(self, images_tanh=None, features=None):
        return 50.0 / self.calls


def train_run(model: str, save_root: str) -> str:
    """One jckx run as main.py trains it → its run dir."""
    from jckx.checkpoint.checkpoint import flush_writes
    from jckx.configs import get_arg_parse
    from jckx.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
    from jckx.logging.main_logger import MainLogger
    from jckx.models import cgan, dcgan
    from jckx.models.dcgan import GANGeometry
    from jckx.rng import KeyChain, seed_everything
    from jckx.train.gan_trainer import CGANTrainer, DCGANTrainer

    flags, z_dim = RUNS[model]
    cfg = get_arg_parse(["-m", model, "--save_root", save_root,
                         "--data_dir", os.path.join(save_root, "data")] + flags + COMMON)
    cfg.z_dim = z_dim  # jckx's CLI has no --z_dim; a smaller G keeps the files small
    cfg.save_path = os.path.join(save_root, model.lower(), cfg.model_path)
    os.makedirs(cfg.save_path, exist_ok=True)
    with open(os.path.join(cfg.save_path, "config.json"), "w") as f:
        f.write(cfg.to_json())
    keys = KeyChain(seed_everything(cfg.seed))
    geo = GANGeometry(z_dim=cfg.z_dim, image_size=cfg.image_size, channels=cfg.channels,
                      base_width=cfg.base_width)
    if model == "CGAN":
        pre = CGANDataPreprocessor(cfg)
        pre.transform_data()
        cfg.num_classes = pre.num_classes
        pg = cgan.cgenerator_init(keys.next(), geo, pre.num_classes)
        pd = cgan.cdiscriminator_init(keys.next(), geo, pre.num_classes)
        trainer = CGANTrainer(cfg, pg, pd, pre, metrics=StubMetrics())
    else:
        pre = DCGANDataPreprocessor(cfg)
        pre.transform_data()
        pg = dcgan.generator_init(keys.next(), geo)
        pd = dcgan.discriminator_init(keys.next(), geo)
        trainer = DCGANTrainer(cfg, pg, pd, pre, metrics=StubMetrics())
    trainer.train()
    flush_writes()
    MainLogger.reset()
    return cfg.save_path


def render(ckpt: str, z: np.ndarray, labels) -> np.ndarray:
    """jckx's served f32 render of ``z`` (and the one-hot ``labels``)."""
    from jckx.serve import GeneratorService

    svc = GeneratorService(ckpt, batch_size=len(z), compute_dtype=jnp.float32)
    onehot = None if labels is None else jax.nn.one_hot(labels, svc.num_classes)
    return np.asarray(svc.sampler_apply(svc.params_g, jnp.asarray(z), onehot), np.float32)


def make(out: str) -> None:
    from jckx.utils.device import honor_jax_platforms_env

    honor_jax_platforms_env()
    os.makedirs(out, exist_ok=True)
    z = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(i), (RUNS["DCGAN"][1],)))
                  for i in range(N_RENDER)]).astype(np.float32)
    labels = (np.arange(N_RENDER) % 10).astype(np.int64)
    np.save(os.path.join(out, "z.npy"), z)
    np.save(os.path.join(out, "cgan_labels.npy"), labels)
    with tempfile.TemporaryDirectory() as tmp:
        for model in RUNS:
            run_dir = train_run(model, tmp)
            dst = os.path.join(out, model.lower(), "run")
            os.makedirs(dst, exist_ok=True)
            for name in ("latest.ckpt", "latest.ckpt.json"):
                shutil.copyfile(os.path.join(run_dir, name), os.path.join(dst, name))
            with open(os.path.join(run_dir, "config.json")) as f:
                stored = json.load(f)
            # the temp dir's paths mean nothing elsewhere
            stored.update(save_root="save", save_path="", data_dir="data")
            with open(os.path.join(dst, "config.json"), "w") as f:
                json.dump(stored, f, indent=2)
            images = render(os.path.join(dst, "latest.ckpt"), z,
                            labels if model == "CGAN" else None)
            np.save(os.path.join(out, f"{model.lower()}_renders.npy"), images)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=HERE)
    make(p.parse_args().out)
