"""How a net's forward lays its activations over a mesh's model axis.

The models (``models/dcgan.py``, ``models/cgan.py``) run every layer
through a layout object, which decides where each activation lives and
which collectives connect the layers:

- ``Layout`` (this module): nothing on the model axis. Every member holds
  whole activations; BN takes its statistics over the data axis of
  ``mesh`` (or over one device without a mesh). This is the layout of a
  run without a model axis and of every eval sampler, and it is what the
  models did before the model axis existed;
- ``TensorParallel`` (``parallel/tp.py``): each member holds its slice of
  the wide layers' output channels;
- ``Spatial`` (``parallel/spatial.py``): each member holds its block of
  the activations' rows (height).

The calls take the global height ``h`` of the activation they are given
(the spatial layout tells a member's block from whole rows by it) and, for
``bn_act``, the layer's full width ``width`` (the tensor-parallel layout
gathers a slice to it). Beyond the forward, a layout says how the train
step reads the WGAN-GP penalty's input gradient (``input_grad``,
``row_sumsq``) and which rows of an image batch a member holds
(``images``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jckx_torch.kernels.fused_bn_act import bn_act
from jckx_torch.ops.conv import conv2d, conv_transpose2d


class Layout:
    """Whole activations on every member (see the module docstring)."""

    mode = "none"

    def __init__(self, mesh=None, subpixel: bool = False, bn=None):
        self.mesh = mesh
        self.subpixel = subpixel
        self.bn = bn_act if bn is None else bn  # the models pass their module's bn_act

    def conv2d(self, x, w, stride: int, padding: int, h: int):
        return conv2d(x, w, stride=stride, padding=padding)

    def conv_transpose2d(self, x, w, stride: int, padding: int, h: int):
        return conv_transpose2d(x, w, stride=stride, padding=padding, subpixel=self.subpixel)

    def bn_act(self, x, scale, bias, act: str, width: int, h: int):
        return self.bn(x, scale, bias, act=act, negative_slope=0.2, mesh=self.mesh)

    def full_height(self, x, h: int):
        """x with all ``h`` of its rows on this member."""
        return x

    def vector(self, v, n: int):
        """A 1-D parameter of full length ``n``."""
        return v

    def linear(self, x, w, b, n_out: int):
        """``F.linear`` with a bias of full length ``n_out``."""
        return F.linear(x, w, self.vector(b, n_out))

    def images(self, x: torch.Tensor) -> torch.Tensor:
        """This member's part of an NHWC image batch (its data rows)."""
        return x

    def input_grad(self, g: torch.Tensor, image_h: int) -> torch.Tensor:
        """The gradient of the global score with respect to this member's
        images (of global height ``image_h``), from this member's autograd
        (``parallel/mesh.py``)."""
        return g

    def row_sumsq(self, s: torch.Tensor, image_h: int) -> torch.Tensor:
        """Per-row sums of squares of an image-shaped tensor (of global
        height ``image_h``) over all of its pixels, from this member's part."""
        return s


def make_layout(mesh, mode: str):
    """The train step's layout for ``mesh`` and ``--model_axis_mode``: None
    without a model axis (the nets then take ``mesh`` for data-axis BN)."""
    if mesh is None or mesh.model_size == 1:
        return None
    if mode == "tp":
        from jckx_torch.parallel.tp import TensorParallel

        return TensorParallel(mesh)
    if mode == "spatial":
        from jckx_torch.parallel.spatial import Spatial

        return Spatial(mesh)
    raise ValueError(f"model_axis_mode={mode!r}: expected tp or spatial")
