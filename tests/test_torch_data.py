"""The port's data path (jckx_torch/data/) against jckx's (jckx/data/) on
the same inputs.

- ``decode_batch`` (uint8 → resize → [-1, 1]) within 1e-6 in f32: the
  same bilinear weights, summed in another order; in bf16 within one bf16
  ulp at |y| ≤ 1. Upsampling (32→64, the reference's 64² path) and
  downsampling (32→16, the tests' tiny geometry) both;
- the synthetic fallback set byte for byte, and every ``load_dataset``
  return value, on miniature archives built in the test (as
  tests/test_archive_parsers.py builds them) and without any archive.
"""

import gzip
import os
import pickle
import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jckx.data import datasets as jds
from jckx.data.pipeline import decode_batch as jdecode
from jckx_torch.configs import Config
from jckx_torch.data import datasets as tds
from jckx_torch.data.pipeline import DCGANDataPreprocessor, decode_batch


@pytest.mark.parametrize("src,size", [(32, 64), (32, 16), (28, 32), (32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_batch_matches_jckx(src, size, dtype):
    u8 = np.random.RandomState(src + size).randint(0, 256, (3, src, src, 3), np.uint8)
    ref = np.asarray(jdecode(jnp.asarray(u8), size, getattr(jnp, dtype)), np.float32)
    got = decode_batch(torch.from_numpy(u8), size, getattr(torch, dtype))
    assert got.shape == (3, size, size, 3) and got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("args", [(64, 32, 3, 100, 0), (50, 28, 1, 10, 3), (17, 32, 3, 7, 12345)])
def test_synthetic_dataset_bytes_equal_jckx(args, tmp_path):
    x, y = tds.synthetic_dataset(*args, cache_dir=str(tmp_path))
    rx, ry = jds.synthetic_dataset(*args, cache_dir=str(tmp_path))
    assert x.dtype == np.uint8 and x.tobytes() == rx.tobytes()
    assert y.dtype == ry.dtype and y.tobytes() == ry.tobytes()


def _same(got, ref):
    x, y, ncls, names, synthetic = got
    rx, ry, rncls, rnames, rsynthetic = ref
    np.testing.assert_array_equal(np.asarray(x), np.asarray(rx))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(ry))
    assert (ncls, list(names), synthetic) == (rncls, list(rnames), rsynthetic)


def _cifar100(data_dir):
    rng = np.random.RandomState(0)
    d = os.path.join(data_dir, "cifar-100-python")
    os.makedirs(d)
    for split, n in (("train", 12), ("test", 4)):
        with open(os.path.join(d, split), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 255, (n, 3072), dtype=np.uint8),
                         b"fine_labels": rng.randint(0, 100, n).tolist()}, f)


def _cifar10(data_dir):
    rng = np.random.RandomState(1)
    d = os.path.join(data_dir, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 255, (3, 3072), dtype=np.uint8),
                         b"labels": rng.randint(0, 10, 3).tolist()}, f)


def _mnist(data_dir):
    rng = np.random.RandomState(2)
    for name, arr in (("train-images-idx3-ubyte", rng.randint(0, 255, (5, 28, 28), dtype=np.uint8)),
                      ("train-labels-idx1-ubyte", rng.randint(0, 10, 5).astype(np.uint8))):
        with gzip.open(os.path.join(data_dir, name + ".gz"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, *arr.shape) if arr.ndim == 3
                    else struct.pack(">II", 2049, arr.shape[0]))
            f.write(arr.tobytes())


@pytest.mark.parametrize("name,make", [("cifar100", _cifar100), ("cifar10", _cifar10),
                                       ("mnist", _mnist)])
def test_archive_parsers_match_jckx(name, make, tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "jckx"
    for d in (ours, ref):
        d.mkdir()
        make(str(d))
    _same(tds.load_dataset(name, str(ours)), jds.load_dataset(name, str(ref)))


@pytest.mark.parametrize("name", ["cifar100", "cifar10", "mnist", "synthetic"])
def test_missing_archive_falls_back_like_jckx(name, tmp_path):
    kw = dict(seed=4, synthetic_n=40)
    got = tds.load_dataset(name, str(tmp_path / "a"), **kw)
    assert got[4] is True
    _same(got, jds.load_dataset(name, str(tmp_path / "b"), **kw))


def test_npz_plane_matches_jckx_and_never_falls_back(tmp_path):
    path = str(tmp_path / "set.npz")
    rng = np.random.RandomState(5)
    np.savez(path, x=rng.randint(0, 256, (6, 8, 8, 3), np.uint8), y=np.array([0, 2, 1, 2, 0, 1]),
             names=np.array(["a", "b", "c"]))
    _same(tds.load_dataset("npz", "", data_path=path), jds.load_dataset("npz", "", data_path=path))
    with pytest.raises(ValueError, match="channel"):
        tds.load_dataset("npz", "", data_path=path, channels=1)
    with pytest.raises(ValueError, match="--data_path"):
        tds.load_dataset("npz", "")
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, x=np.zeros((2, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tds.load_dataset("npz", "", data_path=bad)
    with pytest.raises(ValueError, match="no images"):  # the folder plane never falls back either
        tds.load_dataset("folder", "", data_path=str(tmp_path))


def test_class_tables_equal_jckx():
    assert tds.CIFAR100_CLASSES == jds.CIFAR100_CLASSES
    np.testing.assert_array_equal(tds.FINE_TO_SUPERCLASS, jds.FINE_TO_SUPERCLASS)


def test_preprocessor_matches_jckx(tmp_path):
    from jckx.configs import Config as JConfig
    from jckx.data.pipeline import DCGANDataPreprocessor as JPre

    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.dataset, c.synthetic_size, c.data_dir, c.log_file = "cifar10", 48, str(tmp_path), 0
        c.num_classes = 10
    ours, ref = DCGANDataPreprocessor(cfg), JPre(jcfg)
    assert ours.images_u8.tobytes() == ref.images_u8.tobytes()
    np.testing.assert_array_equal(ours.labels_np, ref.labels_np)
    assert (ours.num_classes, ours.class_names) == (ref.num_classes, ref.class_names)
    np.testing.assert_allclose(ours.data_mean, ref.data_mean, rtol=1e-12)
    np.testing.assert_allclose(ours.data_std, ref.data_std, rtol=1e-12)
    assert ours.metric_source[0] is ours.images_u8
