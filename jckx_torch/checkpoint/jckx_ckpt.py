"""A jckx ``.ckpt`` read without JAX — the port's side of
``jckx/checkpoint/checkpoint.py:134-220``.

jckx writes its train state with ``flax.serialization.to_bytes`` and the
trainer's extras into a ``.json`` sidecar beside it (``<path>.json``:
``serve_config``, ``bests``, ``losses``, ``iters``). The state tree:

- ``params_g``, ``params_d``, ``ema_g`` (nil without an EMA): jckx's
  parameter dicts, which ``params_from_jax`` carries to the port's state
  dicts (``torch_convert.py``);
- ``opt_g``, ``opt_d``: ``optax.adam``, a chain stored as the keys ``"0"``
  (``count``, ``mu``, ``nu``) and ``"1"`` (empty). ``mu`` / ``nu`` take the
  parameters' layout map and become torch Adam's ``exp_avg`` /
  ``exp_avg_sq``, keyed by the index of the parameter in
  ``Module.parameters()``; ``count`` becomes each parameter's ``step``. The
  dict is the one ``jckx.checkpoint.adam_state_to_torch`` writes, at the
  lr ``python -m jckx.convert`` writes by default (the file records none;
  every reader sets its own);
- ``step``, and ``rng``: jckx's run key. The port draws from its own
  generators of (seed, step) (``train/steps.py``), so a run resumed from a
  jckx file does not continue jckx's draws; the key is kept as
  ``jckx_rng`` for the record, and the trainer says so in its log.

Geometry, conditioning and K come from the weights' shapes; DCGAN's class
count (which sizes the metrics' head) from the sidecar's ``serve_config``.
``seed`` comes from the run dir's ``config.json`` where one exists (beside
``latest.ckpt``, or one level up from a best-metric file).

→ the dict that ``checkpoint.load_checkpoint`` returns for the port's own
files: ``model_g``, ``model_d``, ``optimizer_g``, ``optimizer_d``,
``step``, ``seed``, ``ema_g``, ``serve_config`` and the sidecar's extras.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from jckx_torch.checkpoint.msgpack import unpackb
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import Config
from jckx_torch.models.cgan import CDiscriminator, CGenerator
from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator

CONVERT_LR = 2e-4  # python -m jckx.convert's --lr default


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            out = json.load(f)
    except (OSError, ValueError):
        return {}
    return out if isinstance(out, dict) else {}


def _geometry(params_g: dict, params_d: dict):
    """(conditional, geometry, K) from jckx's parameter shapes: G's
    ``convt0`` (4, 4, z + K, w0) … ``convt_out`` (4, 4, base, C); CGAN's D
    holds ``label_w`` (K, 2K)."""
    n_up = sum(1 for k in params_g if re.fullmatch(r"convt\d+", k))
    conditional = "label_w" in params_d
    k = int(np.shape(params_d["label_w"])[0]) if conditional else 0
    first, last = np.shape(params_g["convt0"]), np.shape(params_g["convt_out"])
    geo = GANGeometry(z_dim=int(first[2]) - k, image_size=2 ** (n_up + 2),
                      channels=int(last[3]), base_width=int(last[2]))
    return conditional, geo, k


def _adam(opt: Any, net: torch.nn.Module, geo: GANGeometry, which: str) -> Dict[str, Any]:
    """optax's Adam state → a torch Adam state dict for ``net``; {} when the
    file holds none."""
    adam = next((s for s in (opt or {}).values()
                 if isinstance(s, dict) and {"count", "mu", "nu"} <= set(s)), None)
    if adam is None:
        return {}
    count = float(int(adam["count"]))
    mu, nu = params_from_jax(adam["mu"], geo, which), params_from_jax(adam["nu"], geo, which)
    names = [name for name, _ in net.named_parameters()]
    state = {i: {"step": count, "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for i, name in enumerate(names)}
    group = {"lr": CONVERT_LR, "betas": (Config.adam_beta1, Config.adam_beta2), "eps": 1e-8,
             "weight_decay": 0, "amsgrad": False, "maximize": False, "foreach": None,
             "capturable": False, "differentiable": False, "fused": None,
             "params": list(range(len(names)))}
    return {"state": state, "param_groups": [group]}


def _run_seed(path: str) -> Optional[int]:
    here = os.path.dirname(os.path.abspath(path))
    for d in (here, os.path.dirname(here)):
        cfg = _read_json(os.path.join(d, "config.json"))
        if "seed" in cfg:
            return int(cfg["seed"])
    return None


def read_jckx_checkpoint(path: str) -> Dict[str, Any]:
    """A jckx ``.ckpt`` (and its sidecar) → the port's checkpoint dict, on
    the CPU. Raises ``ValueError`` naming ``path`` when the bytes are not
    flax msgpack of a jckx GAN state."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        tree = unpackb(data, source=path)
    except ValueError as e:
        raise ValueError(f"{path} is a malformed jckx checkpoint (a torch checkpoint is a "
                         f"zip archive, a jckx one flax msgpack): {e}") from None
    if not (isinstance(tree, dict) and isinstance(tree.get("params_g"), dict)
            and isinstance(tree.get("params_d"), dict)):
        keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path} is a malformed jckx checkpoint: flax msgpack without "
                         f"'params_g' and 'params_d' (holds {keys})")
    try:
        conditional, geo, k = _geometry(tree["params_g"], tree["params_d"])
        wg, wd = ("cg", "cd") if conditional else ("g", "d")
        G = CGenerator(geo, k) if conditional else Generator(geo)
        D = CDiscriminator(geo, k) if conditional else Discriminator(geo)
        out: Dict[str, Any] = {
            "model_g": params_from_jax(tree["params_g"], geo, wg),
            "model_d": params_from_jax(tree["params_d"], geo, wd),
            "optimizer_g": _adam(tree.get("opt_g"), G, geo, wg),
            "optimizer_d": _adam(tree.get("opt_d"), D, geo, wd),
            "step": int(tree.get("step", 0)),
        }
        if tree.get("ema_g") is not None:
            out["ema_g"] = params_from_jax(tree["ema_g"], geo, wg)
    except (KeyError, ValueError, TypeError, IndexError) as e:
        raise ValueError(f"{path} is a malformed jckx checkpoint: its state tree does not "
                         f"hold a jckx GAN ({type(e).__name__}: {e})") from None
    if tree.get("rng") is not None:
        out["jckx_rng"] = [int(v) for v in np.asarray(tree["rng"]).reshape(-1)]
    seed = _run_seed(path)
    if seed is not None:
        out["seed"] = seed
    sidecar = _read_json(path + ".json")
    for key in ("bests", "losses", "iters"):
        if key in sidecar:
            out[key] = sidecar[key]
    side = sidecar.get("serve_config", {})
    out["serve_config"] = {
        "conditional": conditional, "num_classes": k if conditional else int(side.get("num_classes", 100)),
        "z_dim": geo.z_dim, "image_size": geo.image_size, "channels": geo.channels,
        "base_width": geo.base_width, "ema": "ema_g" in out}
    return out
