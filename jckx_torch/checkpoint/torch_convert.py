"""The reference's torch GAN checkpoints, and weights from the JAX package —
port of ``jckx/checkpoint/torch_convert.py:70-99,169-195``.

The port's modules carry the reference's state-dict names, so a reference
``.pt`` (``torch.save({'model_g', 'model_d', 'optimizer_g',
'optimizer_d'})``, train/dcgan_trainer.py:86-91) loads into them as it is.
``params_from_jax`` carries a ``jckx`` param dict (numpy leaves) over:

- ConvTranspose2d (kh, kw, Cin, Cout) → (Cin, Cout, kh, kw)
- Conv2d          HWIO               → OIHW
- BN              bn{i}_scale / bn{i}_bias → norm{i+1}.weight / .bias, with
  fresh running buffers (never read: BN uses batch statistics).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from jckx_torch.models.dcgan import GANGeometry


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def params_from_jax(params: Dict[str, Any], geo: GANGeometry, which: str = "g") -> Dict[str, torch.Tensor]:
    """jckx DCGAN params (``which`` = "g" or "d") → the port's state dict."""
    if which not in ("g", "d"):
        raise ValueError(f"which must be 'g' or 'd', got {which!r}")
    conv, perm = ("convt", (2, 3, 0, 1)) if which == "g" else ("conv", (3, 2, 0, 1))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(geo.n_up):
        sd[f"conv{i + 1}.weight"] = _t(np.transpose(_np(params[f"{conv}{i}"]), perm))
        scale = _np(params[f"bn{i}_scale"])
        sd[f"norm{i + 1}.weight"] = _t(scale)
        sd[f"norm{i + 1}.bias"] = _t(_np(params[f"bn{i}_bias"]))
        sd[f"norm{i + 1}.running_mean"] = torch.zeros(scale.shape[0])
        sd[f"norm{i + 1}.running_var"] = torch.ones(scale.shape[0])
        sd[f"norm{i + 1}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    sd[f"conv{geo.n_up + 1}.weight"] = _t(np.transpose(_np(params[f"{conv}_out"]), perm))
    return sd


def infer_gan_config(model_g_sd: Dict[str, Any],
                     model_d_sd: Dict[str, Any]) -> Tuple[bool, GANGeometry, int]:
    """(conditional, geometry, num_classes) from a checkpoint's weight shapes.

    The reference's checkpoints carry no config: the CGAN head announces
    itself by ``linear1`` keys, K by the label embedding's output width,
    the layer count gives the image size, G's first conv gives z(+K), the
    last G conv gives base_width and channels.
    """
    conditional = any(k.startswith("linear1.") for k in model_d_sd)
    n_layers = len({k for k in model_g_sd if k.startswith("conv")})
    n_up = n_layers - 1
    image_size = 2 ** (n_up + 2)
    g_first = _np(model_g_sd["conv1.weight"])          # (Cin, 512, 4, 4)
    g_last = _np(model_g_sd[f"conv{n_layers}.weight"])  # (64, C, 4, 4)
    base_width = g_last.shape[0]
    channels = g_last.shape[1]
    if conditional:
        num_classes = _np(model_d_sd["label_embedding.weight"]).shape[1]
        z_dim = g_first.shape[0] - num_classes
    else:
        num_classes = 100
        z_dim = g_first.shape[0]
    geo = GANGeometry(z_dim=z_dim, image_size=image_size,
                      channels=channels, base_width=base_width)
    return conditional, geo, num_classes


def load_reference_checkpoint(path: str) -> Tuple[GANGeometry, Dict[str, Any]]:
    """A reference DCGAN ``.pt`` → (geometry, G's state dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or not {"model_g", "model_d"} <= set(ckpt):
        raise KeyError(f"{path}: not a reference GAN checkpoint (needs "
                       f"'model_g' and 'model_d')")
    conditional, geo, _ = infer_gan_config(ckpt["model_g"], ckpt["model_d"])
    if conditional:
        raise NotImplementedError(f"{path}: CGAN serving not yet ported")
    return geo, ckpt["model_g"]
