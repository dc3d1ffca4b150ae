"""Tensor parallelism over the mesh's model axis — the port of jckx's
``--model_axis_mode tp`` (``jckx/parallel/mesh.py:152-178``,
``jckx/train/gan_trainer.py:253-270``).

jckx shards the state by ``tp_state_sharding`` and lets GSPMD place the
collectives. Here each member of a model group holds its slice of every
leaf the rule shards (``shard_module``) and the forward names the
collectives (``TensorParallel``):

- a sharded layer computes its slice of the output channels from the whole
  input (a convolution with the weight's slice; BN with the slice of its
  scale and bias, whose statistics are the data axis's: each channel's
  rows are all on this member);
- after its activation the slice is all-gathered along channels, so the
  next layer sees the whole input again. jckx leaves that choice to GSPMD;
  a gather after every sharded layer is the simple correct one. Its
  backward is the reduce-scatter of the cotangent (``parallel/mesh.py``);
- a sharded 1-D leaf that feeds a replicated layer (CGAN D's label and fc1
  biases at K = 100) is gathered where it is used (``vector``).

The gradient of a sharded leaf is this member's, a replicated leaf's the
sum of the members' copies; ``ProcessMesh.average_grads`` turns both into
the global mean's (``sharded_flags`` says which is which). The penalty's
input gradient is summed over the model axis and divided by its size
(``input_grad``): every member's images are a copy of the same rows.

Under TP the eval sampler runs on a gathered generator (``gathered``), as
jckx's ``_eval_params_g`` reshards to replicated once per eval, and the
checkpoints hold full tensors (``parallel.mesh.reshard`` gathers on write,
``shard_tree`` slices on read, both by ``payload_dims``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch

from jckx_torch.parallel.layout import Layout
from jckx_torch.parallel.mesh import MODEL_AXIS, module_tp_dims, optimizer_tp_dims

class TensorParallel(Layout):
    """Output channels of the wide layers sharded on the model axis."""

    mode = "tp"

    def bn_act(self, x, scale, bias, act: str, width: int, h: int):
        y = super().bn_act(x, scale, bias, act, width, h)
        return y if y.shape[1] == width else self.mesh.all_gather(y, 1, MODEL_AXIS)

    def vector(self, v, n: int):
        return v if v.shape[0] == n else self.mesh.all_gather(v, 0, MODEL_AXIS)

    def input_grad(self, g, image_h: int):
        return self.mesh.all_reduce(g, MODEL_AXIS) / self.mesh.model_size


def shard_module(net: torch.nn.Module, mesh, min_dim: int, transposed: bool) -> Dict[str, Optional[int]]:
    """Keep this member's slice of every parameter that jckx's rule shards
    (``module_tp_dims`` on the full shapes; ``transposed`` for G's
    ``ConvTranspose2d`` weights), in place; the dims are kept on the net as
    ``tp_dims`` (a deep copy, the EMA, carries them). → the dims."""
    dims = module_tp_dims(net.state_dict(), transposed, min_dim, mesh.model_size)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if dims[name] is not None:
                p.data = p.data.chunk(mesh.model_size, dims[name])[mesh.model_rank].clone()
    net.tp_dims = dims
    return dims


def tp_dims(net: torch.nn.Module) -> Dict[str, Optional[int]]:
    """The net's sharded dims by state-dict key (all None when unsharded)."""
    return getattr(net, "tp_dims", None) or {k: None for k in net.state_dict()}


def sharded_flags(net: torch.nn.Module) -> List[bool]:
    """For each parameter in ``net.parameters()`` order: sharded or not."""
    dims = tp_dims(net)
    return [dims.get(name) is not None for name, _ in net.named_parameters()]


def gathered(net: torch.nn.Module, mesh) -> torch.nn.Module:
    """A copy of ``net`` with whole parameters (every member must call it)."""
    full = copy.deepcopy(net)
    dims = tp_dims(net)
    with torch.no_grad():
        for name, p in full.named_parameters():
            if dims.get(name) is not None:
                p.data = mesh.all_gather(p.data, dims[name], MODEL_AXIS)
    full.tp_dims = None
    return full


def payload_dims(G, D, ema_g, payload: dict) -> dict:
    """The sharded dims of ``state_payload``'s tree, from the nets."""
    out = {"model_g": tp_dims(G), "model_d": tp_dims(D),
           "optimizer_g": optimizer_tp_dims(tp_dims(G), payload.get("optimizer_g", {})),
           "optimizer_d": optimizer_tp_dims(tp_dims(D), payload.get("optimizer_d", {}))}
    if ema_g is not None:
        out["ema_g"] = tp_dims(ema_g)
    return out
