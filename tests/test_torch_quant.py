"""The port's int8 (W8A8) serving quantization (jckx_torch/ops/quant.py)
against jckx's ``jckx/ops/quant.py`` on the CPU, on seeded numpy inputs, at
the tiny geometry (16², base width 8, z 16, batch 8, f32).

Tolerances:
- weight quantization: int8 equal; the per-channel scales within one f32
  ulp (relative 2⁻²³);
- activation quantization and the int8 ConvTranspose (k4 s1 p0 and k4 s2
  p1): exactly equal (integers, int32 accumulation);
- calibration on jckx's own probe batches: scales within 1e-6 relative
  (two float forwards whose convolutions round differently);
- the int8 forward on ``quant_params_from_jax`` of jckx's params: uint8
  within 1 LSB and at least 99 % exactly equal, as the float renders of
  tests/test_torch_serve.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx import serve as jserve
from jckx.models import cgan as jcgan
from jckx.models import dcgan as jdcgan
from jckx.ops import quant as jquant
from jckx_torch import evaluate as tevaluate
from jckx_torch import serve as tserve
from jckx_torch.checkpoint.torch_convert import params_from_jax, quant_params_from_jax
from jckx_torch.models.cgan import CGenerator
from jckx_torch.models.dcgan import GANGeometry, Generator
from jckx_torch.ops import quant as tquant
from test_torch_serve import GEO, _ckpt

TGEO = GANGeometry(z_dim=GEO.z_dim, image_size=GEO.image_size, channels=GEO.channels,
                   base_width=GEO.base_width)
K = 10


def _jckx_g(conditional=False, seed=0):
    """jckx generator params at the tiny geometry, and the port's G on them."""
    key = jax.random.PRNGKey(seed)
    if conditional:
        params = jcgan.cgenerator_init(key, GEO, K)
        G = CGenerator(TGEO, K)
    else:
        params = jdcgan.generator_init(key, GEO)
        G = Generator(TGEO)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    G.load_state_dict(params_from_jax(np_params, TGEO, "cg" if conditional else "g"), strict=True)
    return params, G.requires_grad_(False)


def _jckx_probes(seed, in_dim, batches=2, batch_size=8):
    """jckx's calibration probe batches (``calibrate_generator``'s draws)."""
    key = jquant.serving_calibration_key(seed)
    out = []
    for b in range(batches):
        k = jax.random.fold_in(key, b)
        z = jax.random.normal(k, (batch_size, GEO.z_dim))
        ncls = in_dim - GEO.z_dim
        if ncls > 0:
            lab = jax.random.randint(jax.random.fold_in(k, 1), (batch_size,), 0, ncls)
            z = jnp.concatenate([z, jax.nn.one_hot(lab, ncls, dtype=z.dtype)], axis=-1)
        out.append(torch.from_numpy(np.array(z)))
    return out


def _u8_close(got, ref):
    diff = np.abs(np.asarray(got).astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_weight_quant_matches_jckx():
    w = np.random.RandomState(0).randn(4, 4, 8, 16).astype(np.float32) * 0.02
    w[..., 3] = 0.0  # a dead channel
    jq, js = jquant.quantize_weight_per_channel(w)
    tq, ts = tquant.quantize_weight_per_channel(torch.from_numpy(w.transpose(2, 3, 0, 1).copy()))
    assert tq.dtype == torch.int8 and ts.shape == (16,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(2, 3, 0, 1))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -23, atol=0)
    assert torch.isfinite(ts).all() and (tq[:, 3] == 0).all()


def test_act_quant_matches_jckx():
    """Divide, round half to even, clip: exactly jckx's, ties included."""
    s = np.float32(0.5)
    x = np.concatenate([np.asarray([-63.5, -0.5, 0.0, 0.5, 63.5, 1000.0, -1000.0, 0.25, 0.75,
                                    1.25], np.float32),
                        np.random.RandomState(1).randn(1000).astype(np.float32) * 40])
    want = np.asarray(jquant.quantize_act(jnp.asarray(x), s))
    got = tquant.quantize_act(torch.from_numpy(x), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:7], [-127, -1, 0, 1, 127, 127, -127])


@pytest.mark.parametrize("stride,pad,hw", [(1, 0, 1), (2, 1, 8)])
def test_int8_convt_exactly_jckx(stride, pad, hw):
    rng = np.random.RandomState(1)
    x = rng.randint(-127, 128, (2, hw, hw, 12)).astype(np.int8)
    w = rng.randint(-127, 128, (4, 4, 12, 10)).astype(np.int8)
    want = np.asarray(jquant.conv_transpose2d_int8(jnp.asarray(x), jnp.asarray(w), stride, pad))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    tw = torch.from_numpy(w.transpose(2, 3, 0, 1).copy())
    got = tquant.conv_transpose2d_int8(tx, tw, stride, pad)
    assert got.dtype == torch.int32 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("n,cin,cout,hw,stride,pad", [
    (8, 100, 64, 1, 1, 0),    # DCGAN's first layer: K 100 → 104, 8 rows → 32
    (40, 200, 32, 1, 1, 0),   # CGAN's first layer
    (2, 16, 3, 8, 2, 1),      # the output layer: Cout 3 → 8
    (4, 24, 16, 4, 2, 1),
])
def test_int_mm_route_layout_is_exact(n, cin, cout, hw, stride, pad):
    """The card's im2col + ``_int_mm`` route, run here through the CPU's
    ``torch._int_mm``: its patch matrices, zero padding and interleave give
    exactly the plain f64 route's int32."""
    g = torch.Generator().manual_seed(n * cin)
    x = torch.randint(-127, 128, (n, cin, hw, hw), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (cin, cout, 4, 4), generator=g, dtype=torch.int8)
    got = tquant._conv_transpose2d_int8_int_mm(x, w, stride, pad)
    want = tquant.conv_transpose2d_int8_exact(x, w, stride, pad)
    assert got.dtype == torch.int32 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int8 card route"):
        tquant._conv_transpose2d_int8_int_mm(x, w, 2, 0)


@pytest.mark.parametrize("conditional", [False, True])
def test_calibration_on_jckx_probes(conditional):
    params, G = _jckx_g(conditional)
    in_dim = GEO.z_dim + (K if conditional else 0)
    want = np.asarray(jquant.calibrate_generator(params, GEO, jquant.serving_calibration_key(3),
                                                 in_dim=in_dim, batches=2, batch_size=8))
    probes = _jckx_probes(3, in_dim)
    got = tquant.calibrate_generator(G, probes)
    assert got.shape == (GEO.n_up + 1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # make_sampler calibrates on injected probes: those scales, and jckx's int8 weights
    qp, _ = tquant.make_sampler(G, quant="int8", compute_dtype=torch.float32, probes=probes)
    jqp = quant_params_from_jax(jquant.quantize_generator(params, want, GEO), TGEO)
    for k, v in qp.items():
        if v.dtype == torch.int8:
            assert torch.equal(v, jqp[k]), k
        elif k.startswith("a"):
            np.testing.assert_allclose(v.numpy(), jqp[k].numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("conditional", [False, True])
def test_quantized_forward_matches_jckx(conditional):
    """Both int8 forwards on one set of int8 params (jckx's, carried over)."""
    params, G = _jckx_g(conditional, seed=4)
    in_dim = GEO.z_dim + (K if conditional else 0)
    scales = jquant.calibrate_generator(params, GEO, jquant.serving_calibration_key(0),
                                        in_dim=in_dim, batches=2, batch_size=8)
    jqp = jquant.quantize_generator(params, scales, GEO)
    tqp = quant_params_from_jax(jqp, TGEO)
    assert tqp["convt0_q"].dtype == torch.int8 and tqp["convt0_q"].shape == (in_dim, TGEO.stage_widths()[0], 4, 4)
    rng = np.random.RandomState(5)
    z = rng.randn(8, GEO.z_dim).astype(np.float32)
    if conditional:
        z = np.concatenate([z, np.eye(K, dtype=np.float32)[rng.randint(0, K, 8)]], axis=1)
    want = jserve.tanh_to_u8(jquant.quantized_generator_apply(jqp, jnp.asarray(z), GEO))
    got = tserve.tanh_to_u8(tquant.quantized_generator_apply(tqp, torch.from_numpy(z), TGEO))
    assert got.shape == (8, 16, 16, 3)
    _u8_close(got.numpy(), want)
    # the port's own quantization of the same weights gives the same int8 params
    mine = tquant.quantize_generator(G, torch.from_numpy(np.array(scales)))
    assert set(mine) == set(tqp)
    for k, v in mine.items():
        if v.dtype == torch.int8:
            assert torch.equal(v, tqp[k]), k


def test_quantize_generator_rejects_bad_scales():
    _, G = _jckx_g()
    with pytest.raises(ValueError, match="act_scales"):
        tquant.quantize_generator(G, torch.ones(GEO.n_up + 3))
    with pytest.raises(ValueError, match="quant="):
        tquant.make_sampler(G, quant="int4")


def test_service_quant_int8(tmp_path):
    """``GeneratorService(quant="int8")`` serves uint8 deterministically
    per seed, close to the float service's pixels on the same seed, and
    its renders are the int8 forward of its own params."""
    _, path = _ckpt(tmp_path)
    q = tserve.GeneratorService(path, batch_size=8, compute_dtype=torch.float32,
                                quant="int8", device="cpu")
    f32 = tserve.GeneratorService(path, batch_size=8, compute_dtype=torch.float32, device="cpu")
    a = q.sample(8, seed=7)
    assert a.shape == (8, 16, 16, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, q.sample(8, seed=7))
    diff = np.abs(a.astype(np.int32) - f32.sample(8, seed=7).astype(np.int32))
    assert diff.mean() < 3.0, diff.mean()
    z = torch.randn(8, GEO.z_dim, generator=torch.Generator().manual_seed(1))
    want = tserve.tanh_to_u8(tquant.quantized_generator_apply(q.params, z, q.geo))
    assert torch.equal(q.render(z), want)
    with pytest.raises(ValueError, match="quant="):
        tserve.GeneratorService(path, batch_size=4, quant="int4", device="cpu")


def test_service_quant_int8_conditional(tmp_path):
    _, path = _ckpt(tmp_path, conditional=True)
    svc = tserve.GeneratorService(path, batch_size=4, compute_dtype=torch.float32,
                                  quant="int8", device="cpu")
    a = svc.sample(4, labels=[1, 2, 3], seed=3)
    np.testing.assert_array_equal(a, svc.sample(4, labels=[1, 2, 3], seed=3))
    assert np.abs(a.astype(int) - svc.sample(4, labels=[7], seed=3).astype(int)).max() > 0
    assert svc.params["convt0_q"].shape[0] == GEO.z_dim + K


def _assert_same_params(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_evaluate_scores_the_served_params(tmp_path, monkeypatch):
    """The int8 params ``evaluate --quant int8 --calib_seed s`` scores are
    bit for bit those ``serve --quant int8 --seed s`` serves, for any
    serving batch size; ``--seed`` (the eval noise) does not reach the
    calibration."""
    _, path = _ckpt(tmp_path)
    served = tserve.GeneratorService(path, batch_size=512, compute_dtype=torch.float32,
                                     quant="int8", seed=7, device="cpu").params
    small = tserve.GeneratorService(path, batch_size=32, compute_dtype=torch.float32,
                                    quant="int8", seed=7, device="cpu").params
    _assert_same_params(served, small)

    seen = []
    real = tevaluate.make_sampler

    def spy(G, **kw):
        params, apply = real(G, **kw)
        if kw.get("quant") == "int8":
            seen.append((kw["seed"], params))
        return params, apply

    monkeypatch.setattr(tevaluate, "make_sampler", spy)

    class Stub:
        def extract_features(self, images):
            assert images.shape == (64, 16, 16, 3) and torch.isfinite(images).all()
            return np.random.RandomState(0).randn(len(images), 8).astype(np.float32)

        def inception_score(self, logits=None):
            return 1.5

        def fid(self, features=None):
            return 12.0

    base = ["--ckpt", path, "--device", "cpu", "--compute_dtype", "float32", "--quant", "int8"]
    res = tevaluate.evaluate(tevaluate.get_args(base + ["--calib_seed", "7"]), metrics=Stub())
    assert res == {"step": 0, "n": 64, "quant": "int8", "is": 1.5, "fid": 12.0}
    tevaluate.evaluate(tevaluate.get_args(base + ["--seed", "3"]), metrics=Stub())
    res = tevaluate.evaluate(tevaluate.get_args(base + ["--truncation", "0.5"]), metrics=Stub())
    assert res["truncation"] == 0.5 and res["quant"] == "int8"
    assert [s for s, _ in seen] == [7, 0, 0]
    _assert_same_params(seen[0][1], served)
    with pytest.raises(ValueError, match="truncation"):
        tevaluate.evaluate(tevaluate.get_args(["--ckpt", path, "--truncation", "-0.5"]))
