"""Checkpoints and resume — port of ``jckx/checkpoint/checkpoint.py``.

The reference (train/dcgan_trainer.py:76-99) keeps one checkpoint per
metric in ``save/<model>/<ts>/<metric>/``, deleting the previous one, as
``torch.save({model_g, model_d, optimizer_g, optimizer_d})`` named
``<iters>_<value>.pt``, beside a grid of fakes. Its resume is stubbed out
(dcgan_trainer.py:102-107); jckx implements it with a ``latest.ckpt``
rewritten at every eval.

The port writes the reference's dict, with its own extras beside the four
keys: ``step``, ``seed``, ``ema_g`` (when EMA is on), and what the trainer
adds (``bests``, ``losses``, ``serve_config``, ``iters``). Every value is
a tensor, a number, a string or a container of those, so the file loads
with ``weights_only=True``, and the readers of the reference's format
read it as it is: ``jckx.checkpoint.import_torch_gan_checkpoint`` (which
takes the four keys and ignores the rest) and ``jckx_torch.serve``. The
best-metric files are ``.pt``; ``latest.ckpt`` holds the same dict for
``--resume``. Writes are synchronous and atomic (a temporary file, then
``os.replace``).

``load_checkpoint`` reads three kinds of file into that one dict: the
port's, the reference's ``.pt`` (both zip archives, ``torch.save``'s
format), and jckx's ``.ckpt`` (flax msgpack and a ``.json`` sidecar, read
without JAX by ``jckx_ckpt.read_jckx_checkpoint``). It sniffs the bytes, not
the name: a zip is torch's, anything else is read as jckx's. Every reader
of a checkpoint goes through it: ``load_generator`` (serving, the daemon,
``--watch``, ``evaluate``, ``export``), ``restore_checkpoint`` (``train
--resume``, which finds jckx's ``latest.ckpt`` by the same name),
``convert`` and ``inspect``.

``load_generator`` is the one reader of a generator for serving and
scoring (``jckx_torch.serve``, ``jckx_torch.evaluate``), with the EMA
generator by default where the file holds one (``jckx/serve.py:169-228``).
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, NamedTuple, Optional

import torch

from jckx_torch.checkpoint.jckx_ckpt import read_jckx_checkpoint
from jckx_torch.checkpoint.torch_convert import infer_gan_config
from jckx_torch.models.cgan import CGenerator
from jckx_torch.models.dcgan import GANGeometry, Generator
from jckx_torch.parallel.mesh import reshard, shard_tree
from jckx_torch.parallel.tp import payload_dims
from jckx_torch.train.state import (GANTrainState, adam_count, ema_copy, load_optimizer_state,
                                     optimizer_state, set_lr)

_EXTRA_KEYS = ("step", "seed", "ema_g")
GEOMETRY_FIELDS = ("z_dim", "image_size", "channels", "base_width")


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def state_payload(state: GANTrainState, extra: Optional[dict] = None) -> Dict[str, Any]:
    """A host copy of the state as the reference's dict plus the extras,
    with full tensors: a state sharded over a model axis is gathered first
    (jckx's snapshot that gathers to replicated, ``jckx/train/
    gan_trainer.py:268-281``), so every rank of such a state must call it."""
    out = {"model_g": state.G.state_dict(), "model_d": state.D.state_dict(),
           "optimizer_g": optimizer_state(state.opt_g), "optimizer_d": optimizer_state(state.opt_d)}
    if state.ema_g is not None:
        out["ema_g"] = state.ema_g.state_dict()
    if _sharded(state):
        out = reshard(out, payload_dims(state.G, state.D, state.ema_g, out), state.mesh)
    out = _cpu(out)
    out.update({"step": int(state.step), "seed": int(state.seed)}, **(extra or {}))
    return out


def _sharded(state: GANTrainState) -> bool:
    """Whether the state's nets hold slices of a model axis (TP)."""
    return state.mesh is not None and getattr(state.G, "tp_dims", None) is not None


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a crash mid-write cannot corrupt the file


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A port, reference or jckx checkpoint → the port's dict, on the CPU.
    A file that is not a zip archive is read as jckx's flax msgpack; a
    malformed one raises ``ValueError`` naming it."""
    if not zipfile.is_zipfile(path):
        return read_jckx_checkpoint(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or not {"model_g", "model_d"} <= set(ckpt):
        raise KeyError(f"{path}: not a reference GAN checkpoint (needs 'model_g' and 'model_d')")
    return ckpt


def checkpoint_step(ckpt: Dict[str, Any]) -> int:
    """The file's ``step``, else (a reference file) G's Adam count, as jckx's
    importer reads it; 0 without either."""
    adam = ckpt.get("optimizer_g", {}).get("state", {})
    return int(ckpt.get("step", int(next(iter(adam.values()))["step"]) if adam else 0))


class LoadedGenerator(NamedTuple):
    G: torch.nn.Module          # on the CPU, no parameter requires grad
    conditional: bool
    geo: GANGeometry
    num_classes: int
    step: int
    used_ema: bool


def load_generator(path: str, use_ema: Optional[bool] = None, conditional: Optional[bool] = None,
                   num_classes: Optional[int] = None,
                   geo_overrides: Optional[dict] = None) -> LoadedGenerator:
    """A checkpoint → its generator and what the weights say about it.

    G is the EMA generator when ``use_ema`` says so, or by default when the
    file holds one; ``use_ema=True`` on a file without ``ema_g`` raises.
    ``conditional``, ``num_classes`` and ``geo_overrides`` (geometry fields)
    are jckx's explicit overrides: the weights are the truth, so one that
    contradicts them raises (``jckx/serve.py:155-168``)."""
    ckpt = load_checkpoint(path)
    inferred_cond, geo, inferred_k = infer_gan_config(ckpt["model_g"], ckpt["model_d"])
    # the port's files name the dataset's class count, which sizes the
    # backbone's head for a DCGAN run too (the weights say only K = 100)
    inferred = {"conditional": inferred_cond, **{f: getattr(geo, f) for f in GEOMETRY_FIELDS},
                "num_classes": int(ckpt.get("serve_config", {}).get("num_classes", inferred_k))}
    explicit = dict(geo_overrides or {})
    if conditional is not None:
        explicit["conditional"] = conditional
    if num_classes is not None:
        explicit["num_classes"] = num_classes
    clashes = {k: (v, inferred[k]) for k, v in explicit.items() if v != inferred[k]}
    if clashes:
        raise ValueError(f"{path}: explicit args contradict the checkpoint's weights "
                         f"(given vs inferred): {clashes}")
    if use_ema and "ema_g" not in ckpt:
        raise ValueError(f"{path} holds no EMA generator (use_ema was requested; reference "
                         f"checkpoints and runs without --ema_decay carry none)")
    used_ema = bool("ema_g" in ckpt if use_ema is None else use_ema)
    k = inferred["num_classes"]
    G = CGenerator(geo, k) if inferred_cond else Generator(geo)
    G.load_state_dict(ckpt["ema_g"] if used_ema else ckpt["model_g"], strict=True)
    return LoadedGenerator(G.requires_grad_(False), inferred_cond, geo, k, checkpoint_step(ckpt),
                           used_ema)


def restore_checkpoint(path: str, state: GANTrainState, lr: float) -> Dict[str, Any]:
    """Load a port or reference checkpoint into ``state`` (in place).

    Weights load strictly; Adam's moments and counts come along when the
    file has them. The step is the file's ``step``, else (a reference
    file) the Adam count, as jckx's importer reads it. A state sharded over
    a model axis takes its slices of the file's full tensors, so a run
    resumes under any layout. ``lr`` replaces the
    saved learning rate, as jckx's importer takes it from its caller.
    → the file's other keys."""
    ckpt = load_checkpoint(path)
    if _sharded(state):  # full tensors → this member's slices, whatever layout wrote them
        ckpt = shard_tree(ckpt, payload_dims(state.G, state.D, state.ema_g, ckpt), state.mesh)
    state.G.load_state_dict(ckpt["model_g"], strict=True)
    state.D.load_state_dict(ckpt["model_d"], strict=True)
    for key, opt in (("optimizer_g", state.opt_g), ("optimizer_d", state.opt_d)):
        if ckpt.get(key, {}).get("state"):
            load_optimizer_state(opt, ckpt[key])
        elif hasattr(opt, "sync_params"):
            opt.sync_params()
        set_lr(opt, lr)
    state.step = int(ckpt.get("step", adam_count(state.opt_g)))
    state.seed = int(ckpt.get("seed", state.seed))
    has_ema, want_ema = "ema_g" in ckpt, state.ema_g is not None
    if want_ema:
        # a file without an EMA starts the average from G, as jckx's importer does
        state.ema_g = ema_copy(state.G)
        if has_ema:
            state.ema_g.load_state_dict(ckpt["ema_g"], strict=True)
    elif has_ema:
        raise ValueError(f"{path} carries an EMA of G but ema_decay is 0: pass the "
                         f"--ema_decay of the run that wrote it")
    return {k: v for k, v in ckpt.items()
            if k not in ("model_g", "model_d", "optimizer_g", "optimizer_d") + _EXTRA_KEYS}


def latest_checkpoint(run_dir: str) -> Optional[str]:
    p = os.path.join(run_dir, "latest.ckpt")
    return p if os.path.exists(p) else None


class BestMetricCheckpointer:
    """One checkpoint per metric subdir, the reference's retention policy
    (delete the previous one; the file name carries iters and values)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir

    def save(self, typ: str, iters: int, values, payload: Dict[str, Any]) -> str:
        sub = os.path.join(self.run_dir, typ)
        os.makedirs(sub, exist_ok=True)
        tag = "_".join(f"{v:.04f}" for v in values)
        path = os.path.join(sub, f"{iters}_{tag}.pt")
        for fn in os.listdir(sub):
            if fn.endswith(".pt"):
                os.remove(os.path.join(sub, fn))
        save_checkpoint(path, payload)
        return path

    def save_latest(self, payload: Dict[str, Any]) -> str:
        path = os.path.join(self.run_dir, "latest.ckpt")
        save_checkpoint(path, payload)
        return path
