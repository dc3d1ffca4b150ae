"""The port's serving (jckx_torch/serve.py) on the CPU: a reference ``.pt``
written by jckx's ``export_torch_gan_checkpoint``, rendered by the port's
service and by jckx's ``tanh_to_u8(generator_apply(...))`` on the same z.

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
    _, cgan_path = _ckpt(tmp_path, conditional=True)
    with pytest.raises(NotImplementedError, match="CGAN serving not yet ported"):
        _svc(cgan_path)
    with pytest.raises(ValueError, match="jckx.convert"):
        _svc(str(tmp_path / "latest.ckpt"))


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
