"""Checkpoint and artifact introspection: ``python -m jckx_torch inspect
--ckpt <path>`` — port of ``jckx/inspect.py:40-125``.

One JSON answer to "what is this file?" for every kind the port writes or
reads:

- the port's checkpoint (``latest.ckpt``, the best-metric ``.pt``), the
  reference's ``.pt`` and jckx's ``.ckpt`` (flax msgpack, read without
  JAX): step, conditioning, geometry (from the weight shapes), EMA, G / D
  / EMA parameter counts, Adam moment elements, and from the port's extras
  or jckx's sidecar the best metrics and the logged-loss count;
- a sealed ``.pt2`` (``jckx_torch.export``) and jckx's ``.jaxexp``: the
  export sidecar (geometry, batch, platforms, quant) and the file size,
  without deserializing the program (a ``.jaxexp`` needs no JAX here).

It never touches the card: checkpoints load with ``map_location="cpu"``
and nothing here initializes CUDA, so it is safe on a host whose card is
busy or sick (the counterpart of jckx's ``_pin_host_backend``).
"""

from __future__ import annotations

import argparse
import json
import os

_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _param_count(state_dict) -> int:
    """Elements of the module's parameters: the BN running buffers, which
    the generator and discriminator never read, are not counted."""
    return sum(v.numel() for k, v in state_dict.items() if not k.endswith(_BUFFERS))


def _moments(opt) -> int:
    return sum(s[m].numel() for s in (opt or {}).get("state", {}).values()
               for m in ("exp_avg", "exp_avg_sq") if m in s)


def inspect_ckpt(path: str) -> dict:
    """The port's checkpoint, the reference's ``.pt`` or jckx's ``.ckpt``."""
    from jckx_torch.checkpoint.checkpoint import checkpoint_step, load_checkpoint
    from jckx_torch.checkpoint.torch_convert import infer_gan_config

    ckpt = load_checkpoint(path)  # map_location="cpu"
    conditional, geo, k = infer_gan_config(ckpt["model_g"], ckpt["model_d"])
    side = ckpt.get("serve_config", {})
    k = int(side.get("num_classes", k))
    port = "step" in ckpt
    kind = ("jckx checkpoint (flax msgpack)" if "jckx_rng" in ckpt
            else "jckx_torch checkpoint" if port else "reference torch checkpoint")
    info = {
        "kind": kind,
        "step": checkpoint_step(ckpt),
        "conditional": conditional,
        "num_classes": k if conditional else None,
        "geometry": {"z_dim": geo.z_dim, "image_size": geo.image_size,
                     "channels": geo.channels, "base_width": geo.base_width},
        "ema": "ema_g" in ckpt,
        "params_g": _param_count(ckpt["model_g"]),
        "params_d": _param_count(ckpt["model_d"]),
        "opt_moments": _moments(ckpt.get("optimizer_g")) + _moments(ckpt.get("optimizer_d")),
    }
    if port:  # jckx's serve_config is made from the weights where its sidecar is missing
        info["sidecar_present"] = (os.path.exists(path + ".json") if "jckx_rng" in ckpt
                                   else bool(side))
    if "ema_g" in ckpt:
        info["params_ema_g"] = _param_count(ckpt["ema_g"])
    if "bests" in ckpt:
        info["bests"] = ckpt["bests"]
    if "losses" in ckpt:
        info["logged_losses"] = len(ckpt["losses"])
    return info


def inspect_artifact(path: str) -> dict:
    """A ``.pt2`` or ``.jaxexp``: its sidecar, the program left unread."""
    from jckx_torch.export import read_sidecar

    kind = ("exported torch.export artifact (jckx_torch.export)" if path.endswith(".pt2")
            else "exported StableHLO artifact (jckx.export)")
    return {"kind": kind, **read_sidecar(path)}


def inspect_path(path: str) -> dict:
    info = inspect_artifact(path) if path.endswith((".pt2", ".jaxexp")) else inspect_ckpt(path)
    info["path"] = path
    info["file_bytes"] = os.path.getsize(path)
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="jckx_torch checkpoint / artifact introspection (JSON on stdout)")
    p.add_argument("--ckpt", required=True,
                   help="the port's checkpoint, a reference .pt, a jckx .ckpt, a .pt2 or a "
                        ".jaxexp artifact")
    args = p.parse_args(argv)
    print(json.dumps(inspect_path(args.ckpt), indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
