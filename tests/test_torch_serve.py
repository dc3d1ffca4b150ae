"""The port's serving (jckx_torch/serve.py) on the CPU: a reference DCGAN
or CGAN ``.pt`` written by jckx's ``export_torch_gan_checkpoint``, rendered
by the port's service and by jckx's ``tanh_to_u8(generator_apply(...))``
(``cgenerator_apply`` with the one-hot labels) on the same z.

Tolerance on the uint8 images: at most 1 LSB apart and at least 99 %
exactly equal — ``floor`` maps two f32 values a rounding error apart to
neighbouring levels when they straddle a level boundary.
"""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from jckx import serve as jserve
from jckx.checkpoint.torch_convert import export_torch_gan_checkpoint
from jckx.models import cgan as jcgan
from jckx.models import dcgan as jdcgan
from jckx.train.state import make_template_state
from jckx_torch import serve as tserve
from jckx_torch.logging.artifacts import encode_png

GEO = jdcgan.GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)


def _ckpt(tmp_path, conditional=False):
    state = make_template_state(GEO, conditional=conditional, num_classes=10)
    path = str(tmp_path / ("cgan.pt" if conditional else "dcgan.pt"))
    export_torch_gan_checkpoint(state, conditional=conditional, geo=GEO,
                                num_classes=10, path=path)
    return state, path


def _svc(path, bs=8, **kw):
    return tserve.GeneratorService(path, batch_size=bs, device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_matches_jckx_on_same_z(tmp_path, dtype):
    state, path = _ckpt(tmp_path)
    svc = _svc(path, compute_dtype=getattr(torch, dtype))
    z = np.random.RandomState(0).randn(8, GEO.z_dim).astype(np.float32)
    ref = np.asarray(jserve.tanh_to_u8(jdcgan.generator_apply(
        state.params_g, jnp.asarray(z), GEO, compute_dtype=getattr(jnp, dtype))))
    got = svc.render(torch.from_numpy(z)).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (8, 16, 16, 3)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_sample_pads_to_batch_and_is_deterministic(tmp_path):
    _, path = _ckpt(tmp_path)
    svc = _svc(path, compute_dtype=torch.float32)
    a = svc.sample(5, seed=3)
    assert a.shape == (5, 16, 16, 3) and a.dtype == np.uint8
    # every batch renders the full batch and is trimmed afterwards
    np.testing.assert_array_equal(a, svc.sample(8, seed=3)[:5])
    b = svc.sample(20, seed=3)  # three batches of 8
    assert b.shape == (20, 16, 16, 3)
    np.testing.assert_array_equal(b, svc.sample(20, seed=3))
    np.testing.assert_array_equal(b[:5], a)
    # without a seed each request draws fresh noise
    assert not np.array_equal(svc.sample(8), svc.sample(8))


@pytest.mark.parametrize("n", [5, 20, tserve.WINDOW * 8 + 1])
def test_reply_equals_the_concatenated_batches(tmp_path, monkeypatch, n):
    """A request shorter than a batch, one that trims its last batch, and
    one of ``WINDOW`` batches and a row (the window's wait): the reply is
    the request's renders trimmed and concatenated batch by batch, in the
    same shape, dtype and C order, and is counted once as pageable."""
    _, path = _ckpt(tmp_path)
    svc = _svc(path, compute_dtype=torch.float32)
    real, batches = tserve.pipelined_sample, []

    def recording(n, bs, render):
        def kept(made):
            imgs = render(made)
            batches.append(imgs[:min(bs, n - made)].numpy().copy())
            return imgs

        return real(n, bs, kept)

    monkeypatch.setattr(tserve, "pipelined_sample", recording)
    before = dict(tserve.REPLIES)
    got = svc.sample(n, seed=4)
    want = np.concatenate(batches)
    assert len(batches) == -(-n // 8)
    assert got.shape == want.shape == (n, 16, 16, 3) and got.dtype == want.dtype == np.uint8
    assert got.flags.c_contiguous and np.array_equal(got, want)
    assert tserve.REPLIES == {"pinned": before["pinned"], "pageable": before["pageable"] + 1}


def test_a_reply_is_unchanged_by_later_requests(tmp_path):
    """Two held replies stay as they were through a second and a third request."""
    _, path = _ckpt(tmp_path)
    svc = _svc(path, compute_dtype=torch.float32)
    a = svc.sample(20, seed=1)
    a0 = a.copy()
    b = svc.sample(20, seed=2)
    b0 = b.copy()
    svc.sample(20, seed=3)
    assert np.array_equal(a, a0) and np.array_equal(b, b0) and not np.array_equal(a, b)


def test_sample_rejects_bad_requests(tmp_path):
    _, path = _ckpt(tmp_path)
    svc = _svc(path)
    with pytest.raises(ValueError, match="n must be >= 1"):
        svc.sample(0)
    with pytest.raises(ValueError, match="unconditional"):
        svc.sample(4, labels=[1, 2])
    with pytest.raises(ValueError, match="batch_size"):
        _svc(path, bs=0)


def test_service_rejects_checkpoints_it_cannot_serve(tmp_path):
    (tmp_path / "latest.ckpt").write_bytes(b"\x82\xa5flax")  # truncated msgpack
    with pytest.raises(ValueError, match="latest.ckpt is a malformed jckx checkpoint"):
        _svc(str(tmp_path / "latest.ckpt"))
    torch.save({"model_g": {}}, tmp_path / "other.pt")
    with pytest.raises(KeyError, match="not a reference GAN checkpoint"):
        _svc(str(tmp_path / "other.pt"))
    _, cgan_path = _ckpt(tmp_path, conditional=True)  # CGAN is served now
    svc = _svc(cgan_path)
    assert svc.conditional and svc.num_classes == 10 and svc.geo.z_dim == GEO.z_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cgan_render_matches_jckx_on_same_z_and_labels(tmp_path, dtype):
    state, path = _ckpt(tmp_path, conditional=True)
    svc = _svc(path, compute_dtype=getattr(torch, dtype))
    rng = np.random.RandomState(1)
    z = rng.randn(8, GEO.z_dim).astype(np.float32)
    lab = rng.randint(0, 10, 8)
    ref = np.asarray(jserve.tanh_to_u8(jcgan.cgenerator_apply(
        state.params_g, jnp.asarray(z), jnp.asarray(np.eye(10, dtype=np.float32)[lab]), GEO,
        compute_dtype=getattr(jnp, dtype))))
    got = svc.render(torch.from_numpy(z), torch.from_numpy(lab)).numpy()
    assert got.shape == ref.shape == (8, 16, 16, 3)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_cgan_labels_cycle_over_the_request(tmp_path):
    """Row i of a request takes labels[i % len(labels)] across batches, on
    the z the request's generator draws; without labels each batch draws
    its classes after its z."""
    _, path = _ckpt(tmp_path, conditional=True)
    svc = _svc(path, compute_dtype=torch.float32)
    labels = [3, 1, 4]
    got = svc.sample(20, labels=labels, seed=5)  # three batches of 8, the last trimmed
    gen = torch.Generator().manual_seed(tserve._request_seed(5, 0))
    want = []
    for made in (0, 8, 16):
        z = torch.randn((8, GEO.z_dim), generator=gen)
        lab = torch.tensor([labels[(made + i) % 3] for i in range(8)])
        want.append(svc.render(z, lab).numpy())
    np.testing.assert_array_equal(got, np.concatenate(want)[:20])

    rand = svc.sample(8, seed=5)
    gen = torch.Generator().manual_seed(tserve._request_seed(5, 0))
    z = torch.randn((8, GEO.z_dim), generator=gen)
    lab = torch.randint(0, 10, (8,), generator=gen)
    np.testing.assert_array_equal(rand, svc.render(z, lab).numpy())
    assert not np.array_equal(rand, got[:8])
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        svc.sample(4, labels=[10])
    with pytest.raises(ValueError, match="labels"):
        svc.render(z)  # a CGAN render needs its classes


def test_service_without_device_needs_a_card(tmp_path, monkeypatch):
    _, path = _ckpt(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.GeneratorService(path)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_decodes_under_pil(channels):
    img = np.random.RandomState(channels).randint(0, 256, (13, 21, channels), np.uint8)
    dec = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(dec.reshape(img.shape), img)


def test_cli_writes_grid(tmp_path, capsys):
    _, path = _ckpt(tmp_path)
    out = str(tmp_path / "grid.png")
    tserve.main(tserve.get_args(["--ckpt", path, "-n", "10", "-o", out,
                                 "--batch_size", "8", "--device", "cpu"]))
    assert "wrote 10 samples" in capsys.readouterr().out
    grid = np.asarray(Image.open(out))
    assert grid.shape == (2 * 18 + 2, 8 * 18 + 2, 3)  # 2 rows x 8 cols, 2px padding

    _, cgan_path = _ckpt(tmp_path, conditional=True)
    tserve.main(tserve.get_args(["--ckpt", cgan_path, "-n", "3", "-o", out, "--labels", "3,7",
                                 "--batch_size", "8", "--device", "cpu"]))
    assert "wrote 3 samples" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unconditional"):
        tserve.main(tserve.get_args(["--ckpt", path, "--labels", "1", "--device", "cpu"]))


# ------------------------------------------------------------------------
# The rest of the serving surface: truncation, interpolation, the sub-pixel
# sampler, the port's own checkpoints and the CLI. Tolerance on uint8 as
# above: within 1 LSB and at least 99 % exactly equal.


def _u8_close(got, ref):
    diff = np.abs(np.asarray(got).astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_truncated_render_matches_jckx_on_its_draws(tmp_path):
    """jckx's own truncated z (``jax.random.truncated_normal``, its render's
    law) through the port's sampler and jckx's, on the same weights."""
    import jax

    state, path = _ckpt(tmp_path)
    svc = _svc(path, compute_dtype=torch.float32, truncation=0.5)
    z = jax.random.truncated_normal(jax.random.PRNGKey(3), -0.5, 0.5, (8, GEO.z_dim))
    ref = jserve.tanh_to_u8(jdcgan.generator_apply(state.params_g, z, GEO, jnp.float32))
    _u8_close(svc.render(torch.from_numpy(np.array(z))).numpy(), ref)


def test_truncation_service_and_determinism(tmp_path):
    _, path = _ckpt(tmp_path)
    base = _svc(path, compute_dtype=torch.float32)
    trunc = _svc(path, compute_dtype=torch.float32, truncation=0.5)
    assert trunc.truncation == 0.5
    z = trunc.draw_z(torch.Generator().manual_seed(0), (4096, GEO.z_dim))
    assert z.abs().max() <= 0.5 and z.std() > 0.2  # N(0,1) on [-0.5, 0.5]: std 0.28
    a = trunc.sample(8, seed=3)
    np.testing.assert_array_equal(a, trunc.sample(8, seed=3))
    assert np.abs(a.astype(int) - base.sample(8, seed=3).astype(int)).max() > 0
    with pytest.raises(ValueError, match="truncation"):
        _svc(path, truncation=-1.0)


@pytest.mark.parametrize("conditional,kind", [(False, "slerp"), (False, "lerp"), (True, "slerp")])
def test_interpolation_matches_jckx_on_its_endpoints(tmp_path, conditional, kind):
    """jckx's walk between its own endpoint latents (``PRNGKey(seed)``
    draws) against the port's ``interpolation_latents`` on the same
    endpoints, rendered as one batch by the port's sampler."""
    import jax

    _, path = _ckpt(tmp_path, conditional=conditional)
    jsvc = jserve.GeneratorService(path, batch_size=4, compute_dtype=jnp.float32)
    svc = _svc(path, compute_dtype=torch.float32)
    labs = dict(label_a=0, label_b=3) if conditional else {}
    want = jsvc.interpolate(1, 2, steps=5, kind=kind, **labs)
    za, zb = (torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(s), (GEO.z_dim,))))
              for s in (1, 2))
    t = torch.linspace(0, 1, 5)
    onehot = None
    if conditional:
        eye = torch.eye(10)
        onehot = (1 - t[:, None]) * eye[0] + t[:, None] * eye[3]
    got = svc.render_latents(tserve.interpolation_latents(za, zb, t, kind), onehot)
    assert got.shape == want.shape == (5, 16, 16, 3)
    _u8_close(got.numpy(), want)


def test_interpolate_contract(tmp_path):
    _, path = _ckpt(tmp_path)
    svc = _svc(path, compute_dtype=torch.float32)
    row = svc.interpolate(1, 2, steps=5)
    assert row.shape == (5, 16, 16, 3) and row.dtype == np.uint8
    np.testing.assert_array_equal(row, svc.interpolate(1, 2, steps=5))
    assert np.abs(row[0].astype(int) - row[-1].astype(int)).max() > 0
    flat = svc.interpolate(7, 7, steps=3)  # slerp's 0/0 corner falls back to lerp
    np.testing.assert_array_equal(flat[0], flat[1])
    np.testing.assert_array_equal(flat[0], flat[2])
    lerp = svc.interpolate(1, 2, steps=5, kind="lerp")
    assert np.abs(lerp.astype(int) - row.astype(int)).max() > 0
    for bad in (dict(steps=1), dict(steps=4097), dict(kind="x"), dict(label_a=0)):
        with pytest.raises(ValueError):
            svc.interpolate(1, 2, **bad)
    _, cpath = _ckpt(tmp_path, conditional=True)
    csvc = _svc(cpath, compute_dtype=torch.float32)
    row = csvc.interpolate(1, 2, steps=4, label_a=0, label_b=3)
    same = csvc.interpolate(1, 2, steps=4, label_a=0)  # label_b defaults to label_a
    assert row.shape == (4, 16, 16, 3) and np.abs(row[-1].astype(int) - same[-1].astype(int)).max() > 0
    with pytest.raises(ValueError, match="label_a"):
        csvc.interpolate(1, 2, steps=4)
    with pytest.raises(ValueError, match="out of"):
        csvc.interpolate(1, 2, steps=4, label_a=10)


@pytest.mark.parametrize("hw", [1, 4, 8])
def test_subpixel_conv_transpose_matches_jckx_and_torch(hw):
    """The sub-pixel k4 s2 p1 form against jckx's on the same inputs and
    against ``F.conv_transpose2d``: f32, within 1e-5."""
    from jckx.ops.conv import _conv_transpose2d_subpixel_k4s2p1 as jsub
    from jckx_torch.ops.conv import conv_transpose2d

    rng = np.random.RandomState(hw)
    x = rng.randn(2, hw, hw, 6).astype(np.float32)
    w = rng.randn(4, 4, 6, 5).astype(np.float32)
    want = np.asarray(jsub(jnp.asarray(x), jnp.asarray(w)))
    tx, tw = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(w.transpose(2, 3, 0, 1).copy())
    got = conv_transpose2d(tx, tw, stride=2, padding=1, subpixel=True)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
    plain = torch.nn.functional.conv_transpose2d(tx, tw, stride=2, padding=1)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    # any other (k, stride, padding) takes the ordinary form
    torch.testing.assert_close(conv_transpose2d(tx, tw, 1, 0, subpixel=True),
                               torch.nn.functional.conv_transpose2d(tx, tw))


def test_subpixel_sampler_matches_jckx_and_the_default(tmp_path):
    from jckx.ops.conv import subpixel_inference

    state, path = _ckpt(tmp_path)
    sub = _svc(path, compute_dtype=torch.float32, subpixel=True)
    z = np.random.RandomState(2).randn(8, GEO.z_dim).astype(np.float32)
    with subpixel_inference():
        ref = jserve.tanh_to_u8(jdcgan.generator_apply(state.params_g, jnp.asarray(z), GEO,
                                                       compute_dtype=jnp.float32))
    got = sub.render(torch.from_numpy(z)).numpy()
    _u8_close(got, ref)
    # against the default sampler on the same z: jckx's tolerance (tests/test_serve.py:67-78)
    base = _svc(path, compute_dtype=torch.float32).render(torch.from_numpy(z)).numpy()
    assert np.abs(base.astype(int) - got.astype(int)).max() <= 1


def _port_checkpoint(path, step, seed, ema=True, conditional=False):
    """A checkpoint as the port's trainer writes it: the reference dict plus
    ``step``, ``ema_g`` and ``serve_config``."""
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator

    geo = GANGeometry(z_dim=GEO.z_dim, image_size=16, channels=3, base_width=8)
    gen = torch.Generator().manual_seed(seed)
    if conditional:
        g, d, e = (CGenerator(geo, 10, gen=gen), CDiscriminator(geo, 10, gen=gen),
                   CGenerator(geo, 10, gen=gen))
    else:
        g, d, e = Generator(geo, gen=gen), Discriminator(geo, gen=gen), Generator(geo, gen=gen)
    payload = {"model_g": g.state_dict(), "model_d": d.state_dict(), "step": step, "seed": seed,
               "serve_config": {"conditional": conditional, "num_classes": 10}}
    if ema:
        payload["ema_g"] = e.state_dict()
    torch.save(payload, path)
    return g, e


def test_serves_the_ports_latest_ckpt_with_and_without_ema(tmp_path):
    path = str(tmp_path / "latest.ckpt")
    g, e = _port_checkpoint(path, step=12, seed=1)
    svc = _svc(path, compute_dtype=torch.float32)
    assert svc.step == 12 and svc.used_ema and not svc.conditional and svc.num_classes == 10
    z = torch.randn(8, GEO.z_dim, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(svc.render(z), tserve.tanh_to_u8(e(z)))
        live = _svc(path, compute_dtype=torch.float32, use_ema=False)
        assert not live.used_ema and torch.equal(live.render(z), tserve.tanh_to_u8(g(z)))
    _port_checkpoint(path, step=3, seed=2, ema=False)
    svc = _svc(path)
    assert svc.step == 3 and not svc.used_ema
    with pytest.raises(ValueError, match="no EMA"):
        _svc(path, use_ema=True)
    # explicit overrides: ones that agree are taken, ones that contradict the weights raise
    assert _svc(path, geo_overrides={"image_size": 16}, conditional=False).geo.base_width == 8
    for kw in (dict(conditional=True), dict(num_classes=100), dict(geo_overrides={"base_width": 4})):
        with pytest.raises(ValueError, match="contradict"):
            _svc(path, **kw)
    with pytest.raises(ValueError, match="jckx.serve"):
        _svc(str(tmp_path / "g.jaxexp"))


def test_cli_serves_every_mode(tmp_path, capsys):
    """The one-shot CLI from the port's ``latest.ckpt`` and a reference
    ``.pt``: truncation, sub-pixel, int8, interpolation; refusals by name."""
    latest = str(tmp_path / "latest.ckpt")
    _port_checkpoint(latest, step=5, seed=0, conditional=True)
    _, ref = _ckpt(tmp_path)
    out = str(tmp_path / "g.png")
    common = ["--batch_size", "8", "--device", "cpu", "-o", out]
    for ckpt, extra in ((latest, ["--labels", "1,2", "--truncation", "0.7"]),
                        (latest, ["--quant", "int8", "--labels", "3"]),
                        (ref, ["--subpixel", "1", "-n", "10"]),
                        (ref, ["--quant", "int8", "--subpixel", "1"])):
        tserve.main(tserve.get_args(["--ckpt", ckpt] + common + extra))
        assert "samples" in capsys.readouterr().out
        assert Image.open(out).size[0] > 0
    tserve.main(tserve.get_args(["--ckpt", latest, "--interpolate", "3,4", "--steps", "5",
                                 "--labels", "1,7", "--kind", "lerp"] + common))
    assert "5-frame lerp walk" in capsys.readouterr().out
    assert np.asarray(Image.open(out)).shape == (18 + 2, 5 * 18 + 2, 3)
    refusals = (([latest, "--mesh_shape", "4,2"], "1-D"), ([str(tmp_path / "m.jaxexp")], "jckx.serve"),
                ([latest, "--watch", "5"], "--listen"),
                ([latest, "--interpolate", "3,4", "--listen", "8099"], "POST /interpolate"),
                ([latest, "--listen", "host:0"], "--listen expects"),
                ([latest, "--interpolate", "3"], "SEEDA,SEEDB"))
    for argv, match in refusals:
        with pytest.raises(SystemExit, match=match):
            tserve.main(tserve.get_args(["--ckpt"] + argv + common))
