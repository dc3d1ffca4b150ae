"""A step's FLOPs and memory traffic, counted per aten op — the port's
counterpart of XLA's ``compiled.cost_analysis()`` that ``jckx/plan.py``
reads (``:172-175``).

``StepCost`` is a ``TorchDispatchMode``: every aten op that runs while it
is active (forward, backward, the penalty's double backward, a
checkpointed recompute, on any autograd thread) is counted once:

- FLOPs: ``torch.utils.flop_counter``'s registry for the op (matmuls and
  convolutions, forward and backward); other ops count 0, as in that
  counter. ``FlopCounterMode`` itself cannot run the GAN step: its module
  tracker refuses the penalty's ``autograd.grad``.
- bytes: the op's tensor operands and results, each read or written once.
  Eager PyTorch writes every intermediate to memory, so this is an
  unfused upper bound on the traffic, where XLA counts its fused program.
  View ops move nothing and count 0; collectives (``c10d``) count 0 here,
  their traffic is the mesh's (``utils/comm.py``).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = ("c10d", "_c10d_functional")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class StepCost(TorchDispatchMode):
    """``with StepCost() as cost: step()`` → ``cost.flops``, ``cost.bytes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and func.namespace not in _COLLECTIVES:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out
