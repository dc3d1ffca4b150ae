"""The port's data planes on the CPU against jckx's: the image-folder plane
(``load_image_folder``, ``load_dataset("folder")``, ``finetune --dataset
folder``), the archive cache around the CIFAR / MNIST parsers, the
streaming plane's host side (``HostStreamLoader``), ``DeviceDataLoader``,
``PinnedSlabs`` and the metrics engine's slab upload.

Equality is exact: the same uint8 bytes, the same rows, the same order,
the same features. jckx's native binding is pointed at the port's library
(built from the same ``native/jckx_io.cpp``) or at its numpy fallback by
patching its ``_load``, so that it never runs ``make`` in ``native/``
beside tests/test_native_io.py.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from jckx.data import datasets as jds
from jckx.data import native_io as jio
from jckx.data import pipeline as jpipe
from jckx_torch.configs import Config
from jckx_torch.data import datasets as tds
from jckx_torch.data import native_io as tio
from jckx_torch.data import pipeline as tpipe
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.metrics.metrics import Metrics
from torch_threads import one_torch_thread  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401


@pytest.fixture(params=["native", "numpy"])
def jckx_engine(request, monkeypatch):
    lib = tio._load() if request.param == "native" else None
    assert request.param == "numpy" or lib is not None, tio.fallback_reason()
    monkeypatch.setattr(jio, "_load", lambda: lib)
    return request.param


@pytest.fixture(autouse=True)
def _fresh_loggers():
    from jckx.logging.main_logger import MainLogger as JLogger

    yield
    MainLogger.reset()
    JLogger.reset()


# ------------------------------------------------------------ image folder

def _image(rng, size, mode):
    w, h = size
    chans = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    a = rng.randint(0, 256, (h, w, chans)).astype(np.uint8)
    return Image.fromarray(a[..., 0] if chans == 1 else a, mode)


def _write_folder(root, layout, seed=0):
    """PNG and JPEG files of several modes and non-square sizes, in class
    subdirectories or flat, beside a file that is not an image."""
    rng = np.random.RandomState(seed)
    kinds = [((23, 17), "RGB", "png"), ((12, 30), "RGB", "jpg"), ((20, 20), "L", "png"),
             ((15, 9), "RGBA", "png"), ((40, 24), "RGB", "jpeg"), ((9, 14), "L", "jpg")]
    dirs = [os.path.join(root, d) for d in ("cat", "dog")] if layout == "classes" else [root]
    for di, d in enumerate(dirs):
        os.makedirs(d, exist_ok=True)
        for i, (size, mode, ext) in enumerate(kinds):
            _image(rng, size, mode).save(os.path.join(d, f"{di}_{i:02d}.{ext}"))
        open(os.path.join(d, "notes.txt"), "w").write("not an image")
    return str(root)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("layout", ["classes", "flat"])
def test_image_folder_equals_jckx(tmp_path, layout, channels):
    path = _write_folder(tmp_path / "set", layout)
    x, y, ncls, names = tds.load_image_folder(path, src_size=16, channels=channels)
    rx, ry, rncls, rnames = jds.load_image_folder(path, src_size=16, channels=channels)
    assert x.shape == (12 if layout == "classes" else 6, 16, 16, channels) and x.dtype == np.uint8
    assert x.tobytes() == rx.tobytes() and y.tobytes() == ry.tobytes()
    assert (ncls, names) == (rncls, rnames)
    got = tds.load_dataset("folder", "", data_path=path, image_size=16, channels=channels)
    ref = jds.load_dataset("folder", "", data_path=path, image_size=16, channels=channels)
    assert got[0].tobytes() == ref[0].tobytes() and got[2:] == ref[2:]


def test_folder_errors_equal_jckx_and_name_pil(tmp_path, monkeypatch):
    for bad in (tmp_path / "missing", tmp_path):
        for load in (tds.load_image_folder, jds.load_image_folder):
            with pytest.raises((FileNotFoundError, ValueError)) as err:
                load(str(bad))
            assert str(bad) in str(err.value)
    with pytest.raises(ValueError, match="--data_path"):
        tds.load_dataset("folder", "")
    path = _write_folder(tmp_path / "set", "flat")
    monkeypatch.setitem(sys.modules, "PIL", None)  # a Python without Pillow
    with pytest.raises(ImportError, match="PIL"):
        tds.load_dataset("folder", "", data_path=path)


# ------------------------------------------------------------ archive cache

def _plant_cifar100(data_dir, n=40, seed=0):
    rng = np.random.RandomState(seed)
    d = os.path.join(data_dir, "cifar-100-python")
    os.makedirs(d)
    with open(os.path.join(d, "train"), "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                     b"fine_labels": rng.randint(0, 100, n).tolist()}, f)
    return os.path.join(d, "train")


@pytest.mark.parametrize("writer", ["port", "jckx"])
def test_cifar100_cache_is_written_then_mapped_and_shared(tmp_path, writer, jckx_engine):
    data_dir = str(tmp_path / "data")
    pickle_path = _plant_cifar100(data_dir)
    cache = os.path.join(data_dir, "jckx_cache_cifar100_train.bin")
    first, other = (tds, jds) if writer == "port" else (jds, tds)
    x1, y1, ncls, names, synthetic = first.load_dataset("cifar100", data_dir)
    assert os.path.getsize(cache) == 32 + 40 * (3072 + 4) and not synthetic and ncls == 100
    parsed = jds.load_cifar100(data_dir)
    np.testing.assert_array_equal(x1, parsed[0])
    np.testing.assert_array_equal(y1, parsed[1])
    os.remove(pickle_path)  # what follows reads the cache, not the archive
    for pkg in (first, other):
        x2, y2, ncls2, names2, synthetic2 = pkg.load_dataset("cifar100", data_dir)
        np.testing.assert_array_equal(x2, x1)
        np.testing.assert_array_equal(y2, y1)
        assert (ncls2, list(names2), synthetic2) == (100, list(names), False)
    x3, y3 = tds.load_dataset("cifar100", data_dir)[:2]
    assert not x3.flags.writeable and not y3.flags.writeable


# ------------------------------------------------------------ streaming plane, loaders

def _set(n=100, shape=(4, 4, 3), seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(n, *shape)).astype(np.uint8),
            rng.randint(0, 10, size=n))


@pytest.mark.parametrize("workers", [1, 3])
def test_stream_loader_slabs_equal_jckx(workers, jckx_engine):
    imgs, labels = _set()
    imgs.flags.writeable = False  # as the native cache hands it over
    ours, ref = tpipe.HostStreamLoader(imgs, labels, workers), jpipe.HostStreamLoader(
        imgs, labels, workers)
    rng = np.random.RandomState(5)
    try:
        for _ in range(3):
            rows = rng.randint(0, 100, size=24)
            slab, labs = ours.take(rows)
            rslab, rlabs = ref.take(rows)
            assert slab.tobytes() == rslab.tobytes() and labs.tobytes() == rlabs.tobytes()
            assert labs.dtype == rlabs.dtype == np.int32
            out = np.zeros((24, 4, 4, 3), np.uint8)  # a caller's slab, as a pinned view
            got, labs2 = ours.take(rows, out=out)
            assert got is out and out.tobytes() == rslab.tobytes() and labs2.tobytes() == rlabs.tobytes()
            ours.prime(rows)
            ref.prime(rows)
            got, want = ours.take(rows), ref.take(rows)
            assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
            out[:] = 0
            ours.prime(rows)
            got = ours.take(rows, out=out)  # the primed slab, copied into the caller's
            assert got[0] is out and out.tobytes() == rslab.tobytes()
            other = rng.randint(0, 100, size=24)  # primed for other rows: gathered now
            ours.prime(rows)
            assert ours.take(other)[0].tobytes() == imgs[other].tobytes()
    finally:
        ours.close()
        ref.close()


def test_device_loader_epochs_equal_jckx():
    imgs, labels = _set(70, (4, 4, 3))
    ours = tpipe.DeviceDataLoader(imgs, labels, batch_size=16, seed=3, device="cpu")
    ref = jpipe.DeviceDataLoader(imgs, labels, batch_size=16, seed=3)
    assert len(ours) == len(ref) == 4  # the last 6 rows dropped
    for _ in range(2):  # a new permutation each epoch, the same as jckx's
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 4
        for (bx, by), (rx, ry) in zip(got, want):
            assert bx.dtype == torch.uint8 and bx.shape == (16, 4, 4, 3)
            np.testing.assert_array_equal(bx.numpy(), np.asarray(rx))
            np.testing.assert_array_equal(by.numpy(), np.asarray(ry))
    unshuffled = tpipe.DeviceDataLoader(imgs, labels, batch_size=16, shuffle=False, device="cpu")
    np.testing.assert_array_equal(next(iter(unshuffled))[0].numpy(), imgs[:16])


def test_preprocessor_keeps_the_reference_calls(tmp_path):
    cfg = Config()
    cfg.dataset, cfg.synthetic_size, cfg.batch_size, cfg.data_dir = "synthetic", 40, 16, str(tmp_path)
    cfg.device, cfg.log_file = "cpu", 0
    pre = tpipe.DCGANDataPreprocessor(cfg)
    assert pre.transform_data() is None
    loader, (imgs, labels) = pre.get_data_loader()
    assert imgs is pre.images_u8 and labels is pre.labels_np and len(loader) == 2
    bx, by = next(iter(loader))
    assert bx.shape == (16, 32, 32, 3) and bx.device.type == "cpu"
    order = np.random.RandomState(cfg.seed).permutation(40)[:16]
    np.testing.assert_array_equal(bx.numpy(), pre.images_u8[order])


def test_pinned_slabs_alternate_and_own_their_bytes():
    slabs = tpipe.PinnedSlabs("cpu", [((2, 3), torch.uint8), ((), torch.int64)], max_rows=5)
    got = []
    for i in range(3):
        u8, labs = slabs.fill(4 if i < 2 else 5)
        u8[:] = i + 1
        labs[:] = -i
        got.append(slabs.upload(u8.shape[0]))
        assert got[-1].event is None
    assert slabs.stream is None
    assert slabs.fill(1)[0].ctypes.data == slabs._host[1][0].numpy().ctypes.data  # in turn
    for i, slab in enumerate(got):  # every upload kept its bytes while the buffers were refilled
        u8, labs = slabs.use(slab)
        assert u8.shape == ((4 if i < 2 else 5), 2, 3) and (u8 == i + 1).all() and (labs == -i).all()


# ------------------------------------------------------------ metrics slabs

class _StubBackbone(torch.nn.Module):
    """A per-sample stand-in for InceptionV3 at 299²: a fixed projection of
    each image's 4 x 4 grid of channel means."""

    def __init__(self, k=10):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(48, k, generator=torch.Generator().manual_seed(0)))

    def forward(self, x, cd, fast_stem=False):
        pooled = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2).float(), 4)
        return pooled.reshape(x.shape[0], -1) @ self.w


def _per_batch(m, images, to01):
    """The engine's host path before slabs: one pageable copy per batch,
    the last batch padded with its last row."""
    n = images.shape[0]
    bs = min(m.batch_size, n)
    outs = []
    with torch.inference_mode():
        for i in range(0, n, bs):
            chunk = torch.from_numpy(np.array(images[i:i + bs])).to(m.device)
            if chunk.shape[0] < bs:
                chunk = torch.cat([chunk, chunk[-1:].expand(bs - chunk.shape[0], *chunk.shape[1:])])
            outs.append(m._features01(to01(chunk)))
    return torch.cat(outs)[:n].cpu().numpy()


@pytest.mark.parametrize("n", [21, 24, 3])
def test_metrics_slab_path_equals_per_batch(tmp_path, monkeypatch, n):
    # 8 x 8 x 3 rows at batch 4: 768 bytes a batch, so two batches a slab;
    # 21 rows are 6 batches (the last padded) in 3 slabs, 24 rows 3 full slabs
    monkeypatch.setattr(Metrics, "_SLAB_BYTES", 2 * 4 * 8 * 8 * 3)
    uploads = []
    real_upload = tpipe.PinnedSlabs.upload
    monkeypatch.setattr(tpipe.PinnedSlabs, "upload",
                        lambda self, rows: uploads.append(rows) or real_upload(self, rows))
    rng = np.random.RandomState(n)
    real = rng.randint(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    real.flags.writeable = False  # the cache's mapping
    m = Metrics((real, rng.randint(0, 100, n)), backbone=_StubBackbone(), batch_size=4,
                compute_dtype=torch.float32, cache_dir=str(tmp_path), num_classes=10, device="cpu")
    assert uploads == {21: [8, 8, 8], 24: [8, 8, 8], 3: [3]}[n]
    to01 = lambda u8: u8.to(torch.float32) / 255.0  # noqa: E731
    ref = _per_batch(m, real, to01)
    assert m.real_features.shape == (n, 10) and m.real_features.tobytes() == ref.tobytes()
    on_device = m._batched(torch.from_numpy(np.array(real)), to01)  # the device-tensor path
    assert on_device.tobytes() == ref.tobytes()
    fakes = (rng.rand(n, 8, 8, 3).astype(np.float32) * 2 - 1)  # a host float set takes slabs too
    tanh01 = lambda x: 0.5 * x.to(torch.float32) + 0.5  # noqa: E731
    assert m.extract_features(fakes).tobytes() == _per_batch(m, fakes, tanh01).tobytes()


# ------------------------------------------------------------ finetune --dataset folder

class _Splits(Exception):
    pass


def _jckx_splits(argv, monkeypatch):
    """The (x, y, xt, yt, ncls) jckx's fine-tune ``train`` loads, read from
    its frame when it reaches the model's init."""
    from jckx.metrics import inception_train as jit
    from jckx.metrics import inception_v3 as jiv

    def grab(*a, **k):
        f = sys._getframe(1).f_locals
        raise _Splits({k: f[k] for k in ("x", "y", "xt", "yt", "ncls")})

    monkeypatch.setattr(jiv, "init", grab)
    with pytest.raises(_Splits) as got:
        jit.train(jit.get_args(argv))
    return got.value.args[0]


@pytest.mark.parametrize("valid", ["holdout", "valid_data_path"])
def test_finetune_folder_splits_equal_jckx(tmp_path, monkeypatch, valid):
    from jckx_torch.metrics.inception_train import _load_splits, get_args, train

    train_dir = _write_folder(tmp_path / "train", "classes", seed=1)
    argv = ["--dataset", "folder", "--data_path", train_dir, "--image_size", "75", "-b", "4",
            "-e", "1", "--max_steps_per_epoch", "1", "--eval_samples", "2", "--log_file", "0",
            "--data_dir", str(tmp_path / "data")]
    if valid == "valid_data_path":
        argv += ["--valid_data_path", _write_folder(tmp_path / "valid", "classes", seed=2)]
    ref = _jckx_splits(argv + ["--save_dir", str(tmp_path / "jckx")], monkeypatch)
    args = get_args(argv + ["--save_dir", str(tmp_path / "bk"), "--device", "cpu",
                            "--compute_dtype", "float32", "-mlr", "0.01"])
    x, y, xt, yt, ncls, synthetic = _load_splits(args, MainLogger(args))
    for a, b in ((x, ref["x"]), (y, ref["y"]), (xt, ref["xt"]), (yt, ref["yt"])):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert x.shape[1:] == (75, 75, 3) and ncls == ref["ncls"] == 2 and not synthetic
    assert len(xt) == (1 if valid == "holdout" else 12) and len(x) == (11 if valid == "holdout" else 12)
    if valid == "holdout":  # one step through the entry point's train()
        run = train(args)
        assert [e["steps"] for e in run.epochs] == [1] and np.isfinite(run.epochs[0]["train_loss"])
        assert (tmp_path / "bk" / "loss_bset.npz").exists()
