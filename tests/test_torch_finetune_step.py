"""The port's fine-tune step (``jckx_torch/metrics/inception_train.py``)
against jckx's ``make_train_step`` on the CPU, and its SGD against optax's.

Two steps at 75², batch 8, f32, K = 10, lr 0.1 (the notebook's), from
jckx's seeded ``init(0)`` carried with ``from_jckx_flat``, on the same
indices, crop draws and dropout masks (rebuilt from jckx's key split and
injected). The second step starts both packages from jckx's state after
the first (weights, running statistics and nesterov traces), so it tests
the momentum without compounding the first step's rounding. jckx's jitted
step is compiled once for the file.

Tolerances, and why they are not tighter. Through 94 layers of
batch-statistic BN the step amplifies f32 rounding: a BN backward whose
input gradient is nearly explained by the per-channel mean and the
normalized input cancels most of it, and the rounding left over grows
from layer to layer toward the stem. XLA's CPU reductions sum in another
order, and less accurately, than torch's pairwise sums, so the two
packages' early-layer deltas part by more than either moves under a
one-ulp change of its inputs. So:
- loss within 1e-3 (measured 3.1e-4), accuracy equal;
- running statistics within 1e-3 of their layer's largest magnitude;
- each leaf's SGD delta within 25 % of jckx's in norm (measured at most
  14.3 %; plain momentum in place of nesterov reads 30 % and 49 %, a lost
  momentum buffer 100 %), the fc's, whose backward path is one matmul,
  within 1e-2 of its largest element on every element.
Weight decay and the nesterov rule are held exactly by the optax test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from jckx.metrics import inception_v3 as jiv
from jckx.metrics.inception_train import make_optimizer as jckx_make_optimizer
from jckx.metrics.inception_train import make_train_step as jckx_make_train_step
from jckx.metrics.metrics import flatten_params
from jckx_torch.data.augment import CropDraws
from jckx_torch.metrics import inception_v3 as tiv
from jckx_torch.metrics.inception_train import StepDraws, make_optimizer, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

K, N, S, LR, WD = 10, 8, 75, 0.1, 5e-4


def _draws(key):
    """jckx's step draws from ``key`` (inception_train.py:83, augment.py:34-44)."""
    k_aug, k_drop = jax.random.split(key)
    k_area, k_ratio, k_y, k_x, k_flip = jax.random.split(k_aug, 5)
    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    crops = CropDraws(
        t(jax.random.uniform(k_area, (N,), minval=0.08, maxval=1.0)),
        t(jax.random.uniform(k_ratio, (N,), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))),
        t(jax.random.uniform(k_y, (N,))), t(jax.random.uniform(k_x, (N,))),
        t(jax.random.bernoulli(k_flip, 0.5, (N,))))
    return StepDraws(crops, t(jax.random.bernoulli(k_drop, 0.5, (N, 2048))))


def _port_step(flat, trace, data, labels, idx, key):
    """One port step from jckx's flat weights (and nesterov traces). →
    (loss, acc, the flat weights after it)."""
    net = tiv.from_jckx_flat(flat)
    opt = make_optimizer(net, LR, WD)
    if trace is not None:
        bufs = dict(tiv.from_jckx_flat(trace).named_parameters())
        for name, p in net.named_parameters():
            opt.state[p]["momentum_buffer"] = bufs[name].detach().clone()
    step = make_train_step(net, opt, torch.float32, S)
    loss, acc = step(torch.from_numpy(data), torch.from_numpy(labels.astype(np.int64)),
                     torch.from_numpy(idx.astype(np.int64)), _draws(key))
    return float(loss), float(acc), tiv.to_jckx_flat(net)


@pytest.fixture(scope="module")
def two_steps():
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (32, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, K, 32).astype(np.int32)
    params = jiv.init(0, num_classes=K)
    jstep, tx, _ = jckx_make_train_step(LR, WD, compute_dtype=jnp.float32, image_size=S)
    opt_state = tx.init(params)
    out = []
    for s in range(2):
        key, idx = jax.random.PRNGKey(10 + s), rng.randint(0, 32, N).astype(np.int32)
        before = flatten_params(jax.device_get(params))
        traces = [st.trace for st in opt_state if hasattr(st, "trace")]
        trace = flatten_params(jax.device_get(traces[0])) if s else None
        params, opt_state, loss, acc = jstep(params, opt_state, jnp.asarray(data),
                                             jnp.asarray(labels), jnp.asarray(idx), key)
        after = flatten_params(jax.device_get(params))
        out.append(dict(before=before, after=after, loss=float(loss), acc=float(acc),
                        port=_port_step(before, trace, data, labels, idx, key)))
    return out


@pytest.mark.parametrize("s", [0, 1])
def test_train_step_matches_jckx(two_steps, s):
    ref = two_steps[s]
    loss, acc, after = ref["port"]
    assert np.isfinite(loss) and abs(loss - ref["loss"]) <= 1e-3
    assert acc == ref["acc"]
    before, jafter = ref["before"], ref["after"]
    assert set(after) == set(jafter)
    for k in after:
        if k.endswith(("bn_mean", "bn_var")):
            np.testing.assert_allclose(after[k], jafter[k], rtol=0,
                                       atol=1e-3 * np.abs(jafter[k]).max(), err_msg=k)
            continue
        d_port, d_jckx = after[k] - before[k], jafter[k] - before[k]
        assert np.abs(d_jckx).max() > 0, k
        gap = np.linalg.norm(d_port - d_jckx) / np.linalg.norm(d_jckx)
        assert gap <= 0.25, (k, gap)
        if k.startswith("fc/"):
            np.testing.assert_allclose(d_port, d_jckx, rtol=0,
                                       atol=1e-2 * np.abs(d_jckx).max(), err_msg=k)


def test_sgd_matches_jckx_optimizer_and_spares_the_running_stats():
    """torch's nesterov SGD with weight decay over the parameters equals
    optax's ``add_decayed_weights`` (masked off ``bn_mean`` / ``bn_var``)
    → ``trace(nesterov)`` → ``scale(-lr)`` over three steps; the running
    statistics are buffers and never move."""
    rng = np.random.RandomState(1)
    m = tiv.BasicConv2d(3, 4, 3)
    with torch.no_grad():
        for t in list(m.parameters()) + [m.bn.running_mean, m.bn.running_var]:
            t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)))
    params = {"w": m.conv.weight.detach().numpy().copy(), "bn_scale": m.bn.weight.detach().numpy().copy(),
              "bn_bias": m.bn.bias.detach().numpy().copy(),
              "bn_mean": m.bn.running_mean.numpy().copy(), "bn_var": m.bn.running_var.numpy().copy()}
    stats = {k: params[k].copy() for k in ("bn_mean", "bn_var")}
    tx = jckx_make_optimizer(LR, WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    opt = make_optimizer(m, LR, WD)
    assert {id(p) for g in opt.param_groups for p in g["params"]} == {
        id(m.conv.weight), id(m.bn.weight), id(m.bn.bias)}
    torch_of = {"w": m.conv.weight, "bn_scale": m.bn.weight, "bn_bias": m.bn.bias}
    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) if k in torch_of else np.zeros_like(v)
                 for k, v in params.items()}
        upd, st = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in torch_of.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for k, p in torch_of.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    for k, buf in (("bn_mean", m.bn.running_mean), ("bn_var", m.bn.running_var)):
        np.testing.assert_array_equal(np.asarray(jp[k]), stats[k])
        np.testing.assert_array_equal(buf.numpy(), stats[k])
