"""The port's metrics (jckx_torch/metrics/) against jckx's (jckx/metrics/).

- The seeded InceptionV3 of ``init(0)`` equals jckx's weight for weight
  (the same numpy draws in the same order), and jckx's flat arrays load
  into the port's torchvision-named modules.
- The eval forward, images in [-1, 1] (and uint8 for the real side)
  through resize to 299, ImageNet normalization and the backbone, against
  jckx's pipeline run eagerly on 2 images, f32: logits within 1e-3 of
  their largest magnitude — 94 convolutions summed in another order.
- FID and IS against ``jckx.metrics.fid`` on seeded features, within 1e-4
  relative (f32 eigh in two libraries).
- Intra-FID against jckx's engine on the same real and fake features: the
  batched path (K = 100, 50 fakes per superclass) and the ragged one
  (K = 10, 10 or 20 fakes per superclass), within 1e-4 relative.
- The engine: the real-feature cache under the port's own file name, the
  seeded-backbone warning, and loud failures.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.metrics import fid as jfid
from jckx.metrics import inception_v3 as jiv
from jckx.metrics.metrics import Metrics as JMetrics, flatten_params
from jckx_torch.metrics import fid as tfid
from jckx_torch.metrics import inception_v3 as tiv
from jckx_torch.metrics.metrics import Metrics
from torch_threads import one_torch_thread  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

K = 10


@pytest.fixture(scope="module")
def seeded():
    """(jckx's seeded params, the port's seeded backbone), num_classes K."""
    return jiv.init(0, num_classes=K), tiv.init(0, num_classes=K)


def test_seeded_backbone_equals_jckx(seeded):
    jp, net = seeded
    ref = tiv.from_jckx_flat(flatten_params(jp)).state_dict()
    ours = net.state_dict()
    assert set(ours) == set(ref) and len(ours) == 94 * 6 + 2
    for k, v in ours.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


def test_torchvision_names_round_trip(seeded):
    _, net = seeded
    sd = {("fc.0." + k[3:] if k.startswith("fc.") else k): v for k, v in net.state_dict().items()}
    sd["AuxLogits.fc.weight"] = torch.zeros(1)  # dropped: not in the eval graph
    back = tiv.from_torchvision(sd).state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, back[k]), k
    assert tiv.init(1, num_classes=K).Mixed_5b.branch1x1.conv.weight.ne(
        net.Mixed_5b.branch1x1.conv.weight).any()


def test_eval_forward_matches_jckx(seeded, tmp_path):
    jp, net = seeded
    rng = np.random.RandomState(0)
    real_u8 = rng.randint(0, 256, (2, 32, 32, 3), np.uint8)
    fake = np.tanh(rng.randn(2, 16, 16, 3)).astype(np.float32)

    def jckx_logits(x01):
        return np.asarray(jiv.apply(jp, JMetrics._normalize_299(None, x01), jnp.float32))

    ref_real = jckx_logits(jnp.asarray(real_u8, jnp.float32) / 255.0)
    ref_fake = jckx_logits(0.5 * jnp.asarray(fake) + 0.5)
    m = Metrics((real_u8, np.zeros(2, np.int32)), backbone=net, batch_size=2,
                compute_dtype=torch.float32, cache_dir=str(tmp_path), num_classes=K, device="cpu")
    got_fake = m.extract_features(torch.from_numpy(fake))
    for got, ref in ((m.real_features, ref_real), (got_fake, ref_fake)):
        assert got.shape == ref.shape == (2, K) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_fid_and_is_math_match_jckx():
    rng = np.random.RandomState(1)
    a = rng.randn(300, 16).astype(np.float32)
    b = (rng.randn(250, 16) @ rng.randn(16, 16) * 0.3 + 0.5).astype(np.float32)
    mu1, s1 = tfid.mean_and_cov(torch.from_numpy(a))
    mu2, s2 = tfid.mean_and_cov(torch.from_numpy(b))
    rmu1, rs1 = jfid.mean_and_cov(jnp.asarray(a))
    rmu2, rs2 = jfid.mean_and_cov(jnp.asarray(b))
    np.testing.assert_allclose(s1.numpy(), np.asarray(rs1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfid.psd_sqrtm(s2).numpy(), np.asarray(jfid.psd_sqrtm(rs2)),
                               rtol=1e-4, atol=1e-5)
    got = float(tfid.frechet_distance(mu1, s1, mu2, s2))
    ref = float(jfid.frechet_distance(rmu1, rs1, rmu2, rs2))
    assert got > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert abs(float(tfid.frechet_distance(mu1, s1, mu1, s1))) < 1e-3

    logits = rng.randn(105, K).astype(np.float32) * 3  # 105: 5 rows past the splits
    probs = torch.softmax(torch.from_numpy(logits), -1)
    ref_is = float(jfid.inception_score_from_probs(jax.nn.softmax(jnp.asarray(logits), -1)))
    np.testing.assert_allclose(float(tfid.inception_score_from_probs(probs)), ref_is, rtol=1e-5)


def test_engine_caches_real_features_and_scores(seeded, tmp_path):
    _, net = seeded
    rng = np.random.RandomState(2)
    real = rng.randint(0, 256, (4, 32, 32, 3), np.uint8)
    labels = np.arange(4, dtype=np.int32)
    kw = dict(backbone=net, batch_size=3, compute_dtype=torch.float32, cache_dir=str(tmp_path),
              num_classes=K, device="cpu")
    m = Metrics((real, labels), **kw)
    (cache,) = [f for f in os.listdir(tmp_path) if f.startswith("metric_data_jckx_torch_")]
    feats = m.real_features
    m2 = Metrics((real, labels), **kw)  # served from the cache
    np.testing.assert_array_equal(m2.real_features, feats)
    Metrics((real[::-1].copy(), labels), **kw)  # other data: another cache file
    assert len(os.listdir(tmp_path)) == 2
    # the real set scored against itself: FID ~ 0; IS of K-class softmax in [1, K]
    np.testing.assert_allclose(m.fid(features=feats), 0.0, atol=1e-2)
    fake = torch.from_numpy(real.astype(np.float32) / 127.5 - 1.0)
    assert m.fid(images_tanh=fake) < 1e-2
    assert 1.0 <= m.inception_score(logits=np.repeat(feats, 3, 0)) <= K


def test_engine_backbone_sources(tmp_path, seeded):
    from jckx_torch.configs import Config

    _, net = seeded
    cfg = Config()
    cfg.save_root, cfg.log_file, cfg.metric_backbone = str(tmp_path / "save"), 0, str(tmp_path / "no.pt")
    src = (np.zeros((1, 8, 8, 3), np.uint8), np.zeros(1, np.int32))
    with pytest.raises(FileNotFoundError, match="refusing"):
        Metrics(src, cfg, cache_dir=str(tmp_path), device="cpu")
    # the fine-tune's place: a torchvision-named .pt there is loaded, not the seeded one
    os.makedirs(tmp_path / "save" / "iception_v3")
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd["fc.bias"] += 1.0
    torch.save(sd, tmp_path / "save" / "iception_v3" / "loss_bset.pt")
    cfg.metric_backbone = ""
    m = Metrics(src, cfg, compute_dtype=torch.float32, cache_dir=str(tmp_path), num_classes=K,
                device="cpu")
    assert torch.equal(m.backbone.fc.bias, sd["fc.bias"])


class _JFeats(JMetrics):
    """jckx's engine with the real features given, not extracted."""

    real = None

    def _extract_u8(self, images_u8):
        return self.real


class _TFeats(Metrics):
    real = None

    def _extract_u8(self, images_u8):
        return self.real


@pytest.mark.parametrize("num_classes", [100, 10], ids=["batched-K100", "ragged-K10"])
def test_intra_fid_matches_jckx(tmp_path, num_classes):
    rng = np.random.RandomState(num_classes)
    d = 12  # feature width: the covariances of 10-50 fakes stay full rank
    labels = np.repeat(np.arange(num_classes), 30).astype(np.int32)
    real = (rng.randn(len(labels), d) + 0.3 * labels[:, None] % 7).astype(np.float32)
    fake = (rng.randn(10 * num_classes, d) * 1.2 + 0.5).astype(np.float32)
    src = (np.zeros((len(labels), 8, 8, 3), np.uint8), labels)
    _JFeats.real = _TFeats.real = real
    ref_engine = _JFeats(src, backbone_params={"w": np.zeros(3, np.float32)},
                         cache_dir=str(tmp_path / "j"), num_classes=num_classes)
    ours = _TFeats(src, backbone=tiv.init(0, num_classes=K), cache_dir=str(tmp_path / "t"),
                   num_classes=num_classes, device="cpu")
    assert ours.active_superclasses == ref_engine.active_superclasses
    assert len(ours.active_superclasses) == (20 if num_classes == 100 else 9)
    for s in ours.active_superclasses:
        np.testing.assert_array_equal(ours.fake_superclass_idx[s], ref_engine.fake_superclass_idx[s])
        np.testing.assert_array_equal(ours.real_superclass_idx[s], ref_engine.real_superclass_idx[s])
    got, ref = ours.intra_fid(features=fake), ref_engine.intra_fid(features=fake)
    assert got > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    s0 = ours.active_superclasses[0]
    sub = fake[ours.fake_superclass_idx[s0]]
    np.testing.assert_allclose(ours.fid(features=sub, intra_fid=True, label=s0),
                               ref_engine.fid(features=sub, intra_fid=True, label=s0), rtol=1e-4)
