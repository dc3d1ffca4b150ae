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
    with pytest.raises(ValueError, match="jckx.convert"):
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
