"""Spatial parallelism over the mesh's model axis — the port of jckx's
``--model_axis_mode spatial`` (``jckx/parallel/mesh.py:81-93``,
``jckx/train/gan_trainer.py:262-286``).

jckx constrains the decoded batch to ``P("data", "model", None, None)``:
the batch on the data axis, the height on the model axis, every leaf
replicated, and GSPMD partitions the convolutions with halo exchanges.
Here each member of a model group holds a contiguous block of every
activation's rows, in model order (``mesh.spatial_sharding``), and
``Spatial`` runs each layer on its block:

- the k4 s2 p1 convolution and transposed convolution need one input row
  of each neighbour (``ProcessMesh.halo``; zeros at the global edges,
  which is the layers' zero padding there). With the halo rows around its
  block a member computes exactly its output rows: a convolution with no
  height padding, a transposed one with a height padding of 3 (its output
  starts two rows into the halo-extended block, less the layer's padding
  of 1);
- G's first layer (1×1 → 4×4, stride 1, padding 0) computes all rows from
  the replicated z and keeps its block;
- D's last convolution (4×4 valid → 1×1) and CGAN D's flatten into fc1
  take all rows (an all-gather of the height) and run on every member;
- a layer whose input or output height the model axis does not divide runs
  on all rows (gathered before it, a member's block taken after it). This
  is a layout choice with the same numbers: jckx runs any M;
- BN sums its statistics over data × model on a block (``"world"``), over
  the data axis on whole rows.

Every leaf is replicated and its gradient on a member covers that
member's rows: ``ProcessMesh.average_grads`` sums them over the world.
The penalty's input gradient is divided by the model axis's size and its
per-row norm summed over it (``input_grad``, ``row_sumsq``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jckx_torch.parallel.layout import Layout
from jckx_torch.parallel.mesh import MODEL_AXIS, WORLD, spatial_sharding
from jckx_torch.ops.conv import conv_transpose2d


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class Spatial(Layout):
    """Activation rows sharded on the model axis (see the module docstring)."""

    mode = "spatial"

    def __init__(self, mesh):
        super().__init__(mesh)
        self.m = mesh.model_size

    def _splits(self, h: int) -> bool:
        return h % self.m == 0

    def _is_block(self, x: torch.Tensor, h: int) -> bool:
        return x.shape[2] != h

    def block(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """This member's rows of an activation of global height ``h``."""
        return x if self._is_block(x, h) else _cl(spatial_sharding(x, self.mesh, 2))

    def full_height(self, x: torch.Tensor, h: int) -> torch.Tensor:
        return self.mesh.all_gather(x, 2, MODEL_AXIS) if self._is_block(x, h) else x

    def conv2d(self, x, w, stride: int, padding: int, h: int):
        if (stride, padding, tuple(w.shape[2:])) == (2, 1, (4, 4)) and self._splits(h) \
                and self._splits(h // 2):
            ext = self.mesh.halo(self.block(x, h))
            return _cl(F.conv2d(ext, w, stride=2, padding=(0, 1)))
        return super().conv2d(self.full_height(x, h), w, stride, padding, h)

    def conv_transpose2d(self, x, w, stride: int, padding: int, h: int):
        if (stride, padding, tuple(w.shape[2:])) == (2, 1, (4, 4)) and self._splits(h):
            ext = self.mesh.halo(self.block(x, h))
            return _cl(F.conv_transpose2d(ext, w, stride=2, padding=(3, 1)))
        y = conv_transpose2d(self.full_height(x, h), w, stride=stride, padding=padding)
        h_out = y.shape[2]
        return self.block(y, h_out) if self._splits(h_out) else y

    def bn_act(self, x, scale, bias, act: str, width: int, h: int):
        axis = WORLD if self._is_block(x, h) else "data"
        return self.bn(x, scale, bias, act=act, negative_slope=0.2, mesh=self.mesh, axis=axis)

    def images(self, x: torch.Tensor) -> torch.Tensor:
        """This member's rows of an NHWC batch: a block of its height, as G's
        last layer leaves its output (whole rows where M does not divide)."""
        return spatial_sharding(x, self.mesh, 1) if self._splits(x.shape[1]) else x

    def input_grad(self, g, image_h: int):
        if self._splits(image_h):  # g is a block of the images' rows
            return g / self.m
        return self.mesh.all_reduce(g, MODEL_AXIS) / self.m

    def row_sumsq(self, s, image_h: int):
        return self.mesh.all_reduce(s, MODEL_AXIS) if self._splits(image_h) else s
