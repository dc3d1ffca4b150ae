"""The reference's torch GAN checkpoints, and weights from the JAX package —
port of ``jckx/checkpoint/torch_convert.py:70-195``.

The port's modules carry the reference's state-dict names, so a reference
``.pt`` (``torch.save({'model_g', 'model_d', 'optimizer_g',
'optimizer_d'})``, train/dcgan_trainer.py:86-91, train/cgan_trainer.py:
82-87) loads into them as it is. ``params_from_jax`` carries a ``jckx``
param dict (numpy leaves) over:

- ConvTranspose2d (kh, kw, Cin, Cout) → (Cin, Cout, kh, kw)
- Conv2d          HWIO               → OIHW
- BN              bn{i}_scale / bn{i}_bias → norm{i+1}.weight / .bias, with
  fresh running buffers (never read: BN uses batch statistics)
- Linear          (in, out)          → (out, in)
- CGAN D's fc1: jckx flattens the trunk's output NHWC (H, W, C rows), the
  reference and the port NCHW (C, H, W rows), so the image block of its
  rows is re-ordered (``_fc1_j2t``, ``:135-146``).

``quant_params_from_jax`` carries jckx's int8 serving params over, so that
a test runs both int8 forwards on one set of parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from jckx_torch.models.dcgan import GANGeometry


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):  # numpy has no bfloat16: such leaves widen to f32
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _fc1_j2t(w: np.ndarray, geo: GANGeometry) -> np.ndarray:
    """jckx fc1_w (flat + 2K, 256), image rows (H, W, C) → the reference's
    linear1.weight (256, flat + 2K), image columns (C, H, W)."""
    s = geo.image_size // 2 ** geo.n_up          # the trunk's spatial size (4)
    c = geo.base_width * 2 ** (geo.n_up - 1)     # its channels (512)
    flat = s * s * c
    img = w[:flat].reshape(s, s, c, -1).transpose(2, 0, 1, 3).reshape(flat, -1)
    return np.concatenate([img, w[flat:]], axis=0).T


def params_from_jax(params: Dict[str, Any], geo: GANGeometry, which: str = "g") -> Dict[str, torch.Tensor]:
    """jckx params → the port's state dict. ``which``: "g" / "d" for DCGAN,
    "cg" / "cd" for CGAN (CGAN's G is DCGAN's stack on z + K inputs)."""
    if which not in ("g", "d", "cg", "cd"):
        raise ValueError(f"which must be 'g', 'd', 'cg' or 'cd', got {which!r}")
    gen = which in ("g", "cg")
    conv, perm = ("convt", (2, 3, 0, 1)) if gen else ("conv", (3, 2, 0, 1))
    sd: Dict[str, torch.Tensor] = {}
    if which == "cd":  # registration order: the label path first
        sd["label_embedding.weight"] = _t(_np(params["label_w"]).T)
        sd["label_embedding.bias"] = _t(_np(params["label_b"]))
    for i in range(geo.n_up):
        sd[f"conv{i + 1}.weight"] = _t(np.transpose(_np(params[f"{conv}{i}"]), perm))
        scale = _np(params[f"bn{i}_scale"])
        sd[f"norm{i + 1}.weight"] = _t(scale)
        sd[f"norm{i + 1}.bias"] = _t(_np(params[f"bn{i}_bias"]))
        sd[f"norm{i + 1}.running_mean"] = torch.zeros(scale.shape[0])
        sd[f"norm{i + 1}.running_var"] = torch.ones(scale.shape[0])
        sd[f"norm{i + 1}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    if which == "cd":
        sd["linear1.weight"] = _t(_fc1_j2t(_np(params["fc1_w"]), geo))
        sd["linear1.bias"] = _t(_np(params["fc1_b"]))
        sd["linear2.weight"] = _t(_np(params["fc2_w"]).T)
        sd["linear2.bias"] = _t(_np(params["fc2_b"]))
    else:
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


def quant_params_from_jax(qp: Dict[str, Any], geo: GANGeometry) -> Dict[str, torch.Tensor]:
    """jckx's int8 serving params (``jckx/ops/quant.py`` ``QuantParams``) →
    the port's (``jckx_torch/ops/quant.py``): the int8 ConvTranspose weights
    (kh, kw, Cin, Cout) → (Cin, Cout, kh, kw); the per-channel weight
    scales, the BN vectors and the per-tensor activation scales as f32."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in qp.items():
        a = _np(v)
        if k.endswith("_q"):
            out[k] = torch.from_numpy(np.ascontiguousarray(np.transpose(a, (2, 3, 0, 1)).astype(np.int8)))
        else:
            out[k] = _t(a)
    want = {f"a{geo.n_up}_scale", "convt_out_q", "convt_out_wscale"} | {
        f"{p}{i}_{s}" for i in range(geo.n_up)
        for p, s in (("convt", "q"), ("convt", "wscale"), ("bn", "scale"), ("bn", "bias"), ("a", "scale"))}
    if set(out) != want:
        raise KeyError(f"not jckx QuantParams for n_up={geo.n_up}: keys {sorted(out)}")
    return out
