"""The nets' weights, made on the device from the run's seed in a few large
draws (the reference's init laws: convolution weights N(0, 0.02), BN
scales N(1, 0.02) and biases 0, CGAN's Linears U(+-1/sqrt(fan_in)) as
``nn.Linear`` makes them), and the reference trainers' ``.pt`` layout
that the program's loader reads (``{"model_g", "model_d", "optimizer_g",
"optimizer_d"}``, the BN layers' running buffers beside their weights).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.gan import param_shapes


def make(cfg: dict, seed: int, device) -> dict:
    """→ {"g": {name: f32 tensor}, "d": {...}} on ``device``."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal, uniform = [], []  # (net, name, shape, law)
    for net in ("g", "d"):
        for name, shape in shapes[net].items():
            if name.startswith(("label_embedding", "linear")):
                uniform.append((net, name, shape))
            elif not name.endswith(".bias"):
                normal.append((net, name, shape))
    out = {"g": {}, "d": {}}
    flat = torch.randn(sum(math.prod(s) for _, _, s in normal), generator=gen, device=device)
    at = 0
    for net, name, shape in normal:
        n = math.prod(shape)
        v = 0.02 * flat[at:at + n].view(shape)
        out[net][name] = v + 1.0 if name.startswith("norm") else v
        at += n
    flat = torch.rand(sum(math.prod(s) for _, _, s in uniform), generator=gen, device=device)
    at = 0
    for net, name, shape in uniform:
        n = math.prod(shape)
        fan_in = shapes[net][name.rsplit(".", 1)[0] + ".weight"][1]
        out[net][name] = (2.0 * flat[at:at + n].view(shape) - 1.0) / math.sqrt(fan_in)
        at += n
    for net in ("g", "d"):
        for name, shape in shapes[net].items():
            if name.startswith("norm") and name.endswith(".bias"):
                out[net][name] = torch.zeros(shape, device=device)
    return {net: {k: out[net][k] for k in shapes[net]} for net in ("g", "d")}


def state_dict(params: dict) -> dict:
    """A net's parameters with ``nn.BatchNorm2d``'s running buffers, as a
    module's ``state_dict`` holds them."""
    out = {}
    for name, v in params.items():
        out[name] = v
        if name.startswith("norm") and name.endswith(".bias"):
            layer = name[:-len(".bias")]
            out[f"{layer}.running_mean"] = torch.zeros_like(v)
            out[f"{layer}.running_var"] = torch.ones_like(v)
            out[f"{layer}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=v.device)
    return out


def write_reference_checkpoint(path: str, params: dict) -> None:
    """The reference trainers' ``.pt`` (train/dcgan_trainer.py:86-91):
    both nets' state dicts and two Adam states that hold no step yet."""
    def adam(n):
        return {"state": {}, "param_groups": [{"lr": 2e-4, "betas": (0.5, 0.999), "eps": 1e-8,
                                               "weight_decay": 0, "amsgrad": False,
                                               "params": list(range(n))}]}

    torch.save({"model_g": {k: v.cpu() for k, v in state_dict(params["g"]).items()},
                "model_d": {k: v.cpu() for k, v in state_dict(params["d"]).items()},
                "optimizer_g": adam(len(params["g"])), "optimizer_d": adam(len(params["d"]))},
               path)
