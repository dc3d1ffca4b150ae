"""The plain reference of the toy family: a two-layer classifier (Linear,
ReLU, Linear) on dicts of named tensors, its cross-entropy, and a plain
SGD step."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def param_shapes(cfg: dict) -> dict:
    """{net: {name: shape}}, the names of ``nn.Sequential``'s state dict."""
    i, h, c = cfg["inputs"], cfg["hidden"], cfg["classes"]
    return {"net": {"0.weight": (h, i), "0.bias": (h,), "2.weight": (c, h), "2.bias": (c,)}}


def loss(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ p["0.weight"].T + p["0.bias"])
    return F.cross_entropy(h @ p["2.weight"].T + p["2.bias"], y)


def sgd_step(p: dict, x: torch.Tensor, y: torch.Tensor, lr: float) -> dict:
    """→ the parameters after one step of plain SGD on (x, y)."""
    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = torch.autograd.grad(loss(p, x, y), list(p.values()))
    return {k: (v - lr * g).detach() for (k, v), g in zip(p.items(), grads)}
