"""The model axis's layout rules and collectives (``jckx_torch/parallel/
mesh.py``, ``tp.py``, ``spatial.py``), on the CPU.

- ``tp_state_sharding`` shards the same leaves as jckx's on jckx's own
  ``(4, 2)`` mesh of 8 virtual devices (tests/test_tensor_parallel.py:35-49):
  DCGAN at 64² / width 64 with ``min_dim`` 128 (G's 512 / 256 / 128 stages
  and D's 128 / 256 / 512, not the 64-wide ones nor the 3-channel and
  1-logit convolutions), the tiny 16² / width 16 with 16, and CGAN at
  K = 100 (D's label and fc1 biases, not their matrices); Adam's moments
  mirror their parameters, on the output-channel dim of each layout.
- On two gloo ranks of a ``(1, 2)`` mesh, in f64: the all-gather, the
  reduce-scatter and the halo exchange equal their unsharded counterparts
  (a concatenation, a sum and a slice, the neighbours' rows with zeros at
  the edges), and pass ``gradcheck`` and ``gradgradcheck`` (each rank's
  block, each rank active in turn); the spatial layout's k4 s2 p1
  convolution and transposed convolution on height blocks equal the
  unsharded ones (tests/test_tensor_parallel.py:52-71), and so do their
  input gradients and the sum over the ranks of their weight gradients.
- The spatial layout's arithmetic is exact: a (1, 2) spatial pair's first
  DCGAN step at 64², width 16, batch 8, computed in f64, gives the plain
  step's telemetry to 2e-7 (the f32 rounding of its parameters, gradients
  and telemetry; the layout's f32 gap at full width is reassociation).
"""

import numpy as np
import jax
import pytest
import torch
import torch.nn.functional as F

from jckx.models import cgan as jcgan
from jckx.models import dcgan as jdcgan
from jckx.models.dcgan import GANGeometry as JGeometry
from jckx.parallel import MODEL_AXIS, make_mesh as jmake_mesh, tp_state_sharding as jtp
from jckx.train.state import make_optimizer
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.parallel import tp_state_sharding
from _torch_dp_child import spawn
from _torch_model_axis_child import collectives_rank, f64_first_step, f64_step_rank
from torch_threads import one_torch_thread  # noqa: F401

RULE_CASES = {  # name: (conditional, geometry, min_dim)
    "dcgan-64": (False, dict(image_size=64, base_width=64), 128),
    "dcgan-tiny": (False, dict(image_size=16, base_width=16, z_dim=16), 16),
    "cgan-64": (True, dict(image_size=64, base_width=64), 128),
}


def _jckx_name(port_key: str, which: str) -> str:
    """The port's state-dict key → jckx's param name (``params_from_jax``'s map)."""
    conv = "convt" if which in ("g", "cg") else "conv"
    head = {"label_embedding.weight": "label_w", "label_embedding.bias": "label_b",
            "linear1.weight": "fc1_w", "linear1.bias": "fc1_b",
            "linear2.weight": "fc2_w", "linear2.bias": "fc2_b"}
    if port_key in head:
        return head[port_key]
    layer, leaf = port_key.split(".")
    idx = int(layer[4:]) - 1
    if layer.startswith("norm"):
        return f"bn{idx}_{'scale' if leaf == 'weight' else 'bias'}"
    return f"{conv}{idx}" if f"{conv}{idx}" in _jckx_name.names else f"{conv}_out"


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_tp_state_sharding_matches_jckx(name):
    conditional, g, min_dim = RULE_CASES[name]
    jgeo, tgeo = JGeometry(**g), GANGeometry(**g)
    key_g, key_d = jax.random.split(jax.random.PRNGKey(0))
    if conditional:
        pg, pd, which = (jcgan.cgenerator_init(key_g, jgeo, 100),
                         jcgan.cdiscriminator_init(key_d, jgeo, 100), ("cg", "cd"))
    else:
        pg, pd, which = (jdcgan.generator_init(key_g, jgeo),
                         jdcgan.discriminator_init(key_d, jgeo), ("g", "d"))
    jmesh = jmake_mesh((4, 2), ("data", MODEL_AXIS))
    tx = make_optimizer(type("C", (), {"lr_schedule": "constant", "max_learning_rate": 2e-4,
                                       "adam_beta1": 0.5, "adam_beta2": 0.999})())
    theirs = {"g": jtp(pg, jmesh, min_dim=min_dim), "d": jtp(pd, jmesh, min_dim=min_dim),
              "mu_g": jtp(tx.init(pg), jmesh, min_dim=min_dim)[0].mu}
    payload = {}
    for net, params, w in (("model_g", pg, which[0]), ("model_d", pd, which[1])):
        payload[net] = params_from_jax({k: np.asarray(v) for k, v in params.items()}, tgeo, w)
    names_g = [k for k in payload["model_g"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    payload["optimizer_g"] = {"state": {i: {"step": torch.tensor(1.0),
                                            "exp_avg": torch.zeros_like(payload["model_g"][k]),
                                            "exp_avg_sq": torch.zeros_like(payload["model_g"][k])}
                                        for i, k in enumerate(names_g)}}
    ours = tp_state_sharding(payload, jmesh, min_dim=min_dim)
    sharded = 0
    for net, w, spec_tree in (("model_g", which[0], theirs["g"]), ("model_d", which[1], theirs["d"])):
        _jckx_name.names = set(spec_tree)
        out_dim = {"g": 1, "cg": 1}.get(w, 0)
        for k, dim in ours[net].items():
            if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                continue
            jspec = spec_tree[_jckx_name(k, w)].spec
            want = None if jspec == jax.sharding.PartitionSpec() else (
                out_dim if payload[net][k].dim() == 4 else 0)
            assert dim == want, f"{name} {net}.{k}: ours {dim}, jckx {jspec}"
            sharded += dim is not None
    _jckx_name.names = set(theirs["g"])
    for i, k in enumerate(names_g):
        jspec = theirs["mu_g"][_jckx_name(k, which[0])].spec
        assert ours["optimizer_g"]["state"][i]["exp_avg"] == ours["model_g"][k], k
        assert (ours["model_g"][k] is None) == (jspec == jax.sharding.PartitionSpec()), k
        assert ours["optimizer_g"]["state"][i]["step"] is None
    assert sharded >= (10 if conditional else 8), f"{name}: only {sharded} leaves sharded"


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_collectives")
    g = torch.Generator().manual_seed(0)
    data = {"x": torch.randn(1, 4, 2, 2, generator=g, dtype=torch.float64),
            "y": torch.randn(2, 1, 4, 2, 1, generator=g, dtype=torch.float64),
            "img": torch.randn(1, 2, 4, 2, generator=g, dtype=torch.float64),
            "conv_x": torch.randn(2, 3, 8, 5, generator=g, dtype=torch.float64),
            "w_conv": torch.randn(4, 3, 4, 4, generator=g, dtype=torch.float64),
            "w_convt": torch.randn(3, 4, 4, 4, generator=g, dtype=torch.float64),
            "v_conv": torch.randn(2, 4, 4, 2, generator=g, dtype=torch.float64),
            "v_convt": torch.randn(2, 4, 16, 10, generator=g, dtype=torch.float64)}
    torch.save(data, tmp / "inputs.pt")
    before = torch.get_num_threads()
    try:
        spawn(collectives_rank, ((1, 2), str(tmp / "store"), str(tmp / "inputs.pt"), str(tmp)),
              world=2, timeout=120)
    finally:
        torch.set_num_threads(before)
    return data, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_collectives_equal_unsharded_ops(collectives):
    data, ranks = collectives
    x, y, img = data["x"], data["y"], data["img"]
    zero = torch.zeros_like(img[:, :, :1])
    halos = [torch.cat([zero, img[:, :, :2], img[:, :, 2:3]], 2),
             torch.cat([img[:, :, 1:2], img[:, :, 2:], zero], 2)]
    for r, rec in enumerate(ranks):
        assert torch.equal(rec["gather"], x)
        assert torch.allclose(rec["scatter"], y.sum(0).chunk(2, 1)[r], rtol=0, atol=1e-15)
        assert torch.equal(rec["halo"], halos[r])


@pytest.mark.parametrize("op", ["gather", "scatter", "halo"])
def test_collectives_pass_gradcheck_to_second_order(collectives, op):
    for r, rec in enumerate(collectives[1]):
        for active in range(2):
            assert rec["checks"][(op, active)] == (True, True), (op, r, active)


@pytest.mark.parametrize("name", ["conv", "convt"])
def test_spatial_convolutions_match_unsharded(collectives, name):
    data, ranks = collectives
    img = data["conv_x"].clone().requires_grad_(True)
    w = data[f"w_{name}"].clone().requires_grad_(True)
    out = (F.conv2d(img, w, stride=2, padding=1) if name == "conv"
           else F.conv_transpose2d(img, w, stride=2, padding=1))
    (out * data[f"v_{name}"]).sum().backward()
    got = [r["conv"][name] for r in ranks]
    torch.testing.assert_close(torch.cat([g["out"] for g in got], 2), out.detach(),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got], 2), img.grad,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[0]["dw"] + got[1]["dw"], w.grad, rtol=1e-12, atol=1e-12)


def test_spatial_step_is_exact_in_f64(tmp_path, monkeypatch):
    from jckx_torch.train import steps

    spawn(f64_step_rank, ((1, 2), str(tmp_path / "store"), str(tmp_path)), timeout=240)
    pair = torch.load(tmp_path / "rank0.pt", weights_only=False)
    monkeypatch.setattr(steps, "compute_dtype", lambda cfg: torch.float64)
    plain = f64_first_step()
    for k, v in plain.items():
        assert abs(pair[k] - v) <= 2e-7 * max(1.0, abs(v)), (k, pair[k], v)
