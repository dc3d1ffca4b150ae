"""Batch-statistic BatchNorm + ReLU with a hand-written backward — port of
``bn_relu_train`` (``jckx/ops/norm.py:89-159``), the fine-tune's BN.

``bn_relu_train(x, scale, bias, eps)`` → ``(out, mean, biased_var)``:
``out`` in x's dtype, the statistics in f32 and without gradient (they
feed the running-stat update only, as jckx's stop-gradient outputs do).
x is NCHW (channels_last on the card) or ``(rows, C)``.

Forward, as jckx's ``_bn_relu_fwd_impl`` (``:115-126``): one moment sweep
(the sum and the sum of squares, accumulated in f32), ``a = scale ·
rsqrt(var + eps)`` and ``sh = bias − mean · a``, then the normalize + ReLU
pass ``relu(f32(x) · a + sh)`` cast back. Both go through registered
operators (``kernels/fused_bn_act.py``) on the free ``(N·H·W, C)`` row
view of the activation. The sweep and the affine are ``_terms``, the
helper ``bn_act`` takes them from: a ``Function``'s forward runs with grad
off, so its sums come from ``jckx_torch::bn_moments`` (on the card the
moments kernels, which read x once in its dtype; on the CPU their plain
version, the f32 sums over N, H, W). The pass is exactly the function of
the repo's one TPU kernel, ``jckx_torch::normalize_act``: on the card the
hand kernel (one launch per call), on the CPU its plain version. On the
card an NCHW input that is not channels_last raises: its row view would be
a copy.

Backward, jckx's two passes (``:134-156``), each a registered operator
(``kernels/fused_bn_act.py``): ``jckx_torch::bn_relu_bwd_sums`` recomputes
the ReLU mask from x (nothing of size x is saved but x itself) and takes
``dbeta = Σ dz`` and ``Σ dz · x`` in one sweep; then, per channel,
``dgamma = inv · (Σ dz · x − mean · dbeta)``; ``jckx_torch::bn_relu_bwd_dx``
writes ``dx = a · (dz − dbeta / n − (x − mean) · inv · dgamma / n)``. On the
card each is a hand-written kernel over x and the incoming gradient as they
come (a channel slice of a concatenated gradient is read in place), whose
mask is the forward kernel's, rounded once; on the CPU each is the plain
torch composition (jckx's VJP is plain jnp, not a Pallas kernel), whose
mask rounds the multiply and the add apart, as jckx's does.

Over a mesh (``mesh``, ``parallel/mesh.py``; jckx's sync-BN under a
sharded jit) the forward's sum and sum of squares are summed over the data
axis before the division by the global row count; the backward's two
reductions, ``Σ dz`` and ``Σ dz · x``, are summed over it as one (2, C)
tensor before ``dx``, while ``dgamma`` and ``dbeta`` stay this rank's own
sums: the train step's gradient average adds the ranks' shares, and would
leave them R times too large from the global sums.

``bn_relu_train_plain`` is the same function as one autograd-differentiated
composition, its statistics ``_terms`` of an x whose gradient is taken
(the plain sums): the reference the card holds the kernel route and the
hand-written backward against (``chip_smoke.py``, ``tests/test_torch_gpu.py``).
With ``one_rounding`` its multiply-add is rounded once, as the kernel's
``fmaf``.
"""

from __future__ import annotations

import torch

from jckx_torch.kernels.fused_bn_act import (_per_channel, _rows, _terms, _unrows,
                                             bn_relu_bwd_dx_op, bn_relu_bwd_sums_op,
                                             normalize_act_op)


class _BNReLUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh):
        if (x.device.type == "cuda" and x.dim() == 4
                and not x.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("bn_relu_train on the card needs a channels_last NCHW tensor")
        mean, var, inv, a, sh = _terms(x, scale, bias, eps, mesh)  # grad off: bn_moments_op
        out = _unrows(normalize_act_op(_rows(x), a, sh, "relu", 0.0), x)
        ctx.save_for_backward(x, a, sh, inv, mean)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, a, sh, inv, mean = ctx.saved_tensors
        n = x.numel() // a.numel()
        sums = bn_relu_bwd_sums_op(x, dout, a, sh)  # this rank's Σdz, Σdz·x
        dbeta = sums[0]
        dgamma = inv * (sums[1] - mean * dbeta)
        dbeta_all, dgamma_all = dbeta, dgamma
        if ctx.mesh is not None:
            # dx needs the global sums; dgamma / dbeta stay this rank's
            # share, which the gradient average over the ranks adds up
            sums = ctx.mesh.all_reduce(sums)
            n *= ctx.mesh.size
            dbeta_all = sums[0]
            dgamma_all = inv * (sums[1] - mean * dbeta_all)
        dx = bn_relu_bwd_dx_op(x, dout, a, sh, mean, dbeta_all / n, inv * dgamma_all / n)
        return dx, dgamma, dbeta, None, None


def bn_relu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-3,
                  mesh=None):
    """relu(batch-norm(x)) with batch statistics (over ``mesh``'s data axis
    when one is given). → (out, mean, biased_var); see the module docstring."""
    return _BNReLUTrain.apply(x, scale, bias, eps, mesh)


def bn_relu_train_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-3, one_rounding: bool = False, mesh=None):
    """``bn_relu_train`` as plain torch ops that autograd differentiates
    (through the statistics); ``one_rounding`` takes the multiply-add in
    f64, rounded once to f32 (and so its ReLU mask is the kernels'). →
    (out, mean, biased_var)."""
    xf = x.float()  # one cast: autograd then sums x's gradient in f32 before rounding it
    mean, var, _, a, sh = _terms(xf, scale, bias, eps, mesh)
    a, sh = _per_channel(a, x), _per_channel(sh, x)
    z = (xf.double() * a.double() + sh.double()).float() if one_rounding else xf * a + sh
    return torch.relu(z).to(x.dtype), mean.detach(), var.detach()
