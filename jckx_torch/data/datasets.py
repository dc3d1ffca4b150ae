"""Dataset loading — port of ``jckx/data/datasets.py`` (numpy only).

CIFAR-100 / CIFAR-10 / MNIST are parsed from the standard local archives
under ``data_dir`` (the reference downloads them through torchvision,
preprocess/dcgan_data_preprocessor.py:20-21; neither machine has network
access). The first parse writes jckx's flat cache
``<data_dir>/jckx_cache_<name>_<split>.bin`` (``_with_cache``,
``data/native_io.py``), and later loads map it with no copy: the same file
name and bytes as jckx's, so a cache written by either package is read by
the other. Without an archive, ``load_dataset`` falls back to the seeded
synthetic set, whose bytes equal jckx's for the same arguments. ``npz``
reads one user file and ``folder`` one directory of images (PIL, imported
when used); neither falls back. Also holds the CIFAR-100 class tables.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Tuple

import numpy as np

# Canonical CIFAR-100 fine-label names in label-index (alphabetical) order.
CIFAR100_CLASSES = [
    "apple", "aquarium_fish", "baby", "bear", "beaver", "bed", "bee", "beetle",
    "bicycle", "bottle", "bowl", "boy", "bridge", "bus", "butterfly", "camel",
    "can", "castle", "caterpillar", "cattle", "chair", "chimpanzee", "clock",
    "cloud", "cockroach", "couch", "crab", "crocodile", "cup", "dinosaur",
    "dolphin", "elephant", "flatfish", "forest", "fox", "girl", "hamster",
    "house", "kangaroo", "keyboard", "lamp", "lawn_mower", "leopard", "lion",
    "lizard", "lobster", "man", "maple_tree", "motorcycle", "mountain",
    "mouse", "mushroom", "oak_tree", "orange", "orchid", "otter", "palm_tree",
    "pear", "pickup_truck", "pine_tree", "plain", "plate", "poppy",
    "porcupine", "possum", "rabbit", "raccoon", "ray", "road", "rocket",
    "rose", "sea", "seal", "shark", "shrew", "skunk", "skyscraper", "snail",
    "snake", "spider", "squirrel", "streetcar", "sunflower", "sweet_pepper",
    "table", "tank", "telephone", "television", "tiger", "tractor", "train",
    "trout", "tulip", "turtle", "wardrobe", "whale", "willow_tree", "wolf",
    "woman", "worm",
]

# Canonical CIFAR-100 superclass table (20 coarse × 5 fine), by name.
CIFAR100_SUPERCLASSES = [
    ("aquatic_mammals", ["beaver", "dolphin", "otter", "seal", "whale"]),
    ("fish", ["aquarium_fish", "flatfish", "ray", "shark", "trout"]),
    ("flowers", ["orchid", "poppy", "rose", "sunflower", "tulip"]),
    ("food_containers", ["bottle", "bowl", "can", "cup", "plate"]),
    ("fruit_and_vegetables", ["apple", "mushroom", "orange", "pear", "sweet_pepper"]),
    ("household_electrical_devices", ["clock", "keyboard", "lamp", "telephone", "television"]),
    ("household_furniture", ["bed", "chair", "couch", "table", "wardrobe"]),
    ("insects", ["bee", "beetle", "butterfly", "caterpillar", "cockroach"]),
    ("large_carnivores", ["bear", "leopard", "lion", "tiger", "wolf"]),
    ("large_man-made_outdoor_things", ["bridge", "castle", "house", "road", "skyscraper"]),
    ("large_natural_outdoor_scenes", ["cloud", "forest", "mountain", "plain", "sea"]),
    ("large_omnivores_and_herbivores", ["camel", "cattle", "chimpanzee", "elephant", "kangaroo"]),
    ("medium_mammals", ["fox", "porcupine", "possum", "raccoon", "skunk"]),
    ("non-insect_invertebrates", ["crab", "lobster", "snail", "spider", "worm"]),
    ("people", ["baby", "boy", "girl", "man", "woman"]),
    ("reptiles", ["crocodile", "dinosaur", "lizard", "snake", "turtle"]),
    ("small_mammals", ["hamster", "mouse", "rabbit", "shrew", "squirrel"]),
    ("trees", ["maple_tree", "oak_tree", "palm_tree", "pine_tree", "willow_tree"]),
    ("vehicles_1", ["bicycle", "bus", "motorcycle", "pickup_truck", "train"]),
    ("vehicles_2", ["lawn_mower", "rocket", "streetcar", "tank", "tractor"]),
]

_NAME_TO_IDX = {n: i for i, n in enumerate(CIFAR100_CLASSES)}
# fine-label index -> superclass index (equivalent to reference metrics.py:23-44)
FINE_TO_SUPERCLASS = np.zeros(100, np.int32)
for _sidx, (_, _members) in enumerate(CIFAR100_SUPERCLASSES):
    for _m in _members:
        FINE_TO_SUPERCLASS[_NAME_TO_IDX[_m]] = _sidx


def superclass_of(fine_label: int) -> int:
    return int(FINE_TO_SUPERCLASS[fine_label])


# ------------------------------------------------------------------ loaders

def _unpickle(f) -> dict:
    return pickle.load(f, encoding="bytes")


def _maybe_extract(data_dir: str, tar_name: str, member_dir: str) -> None:
    tar_path = os.path.join(data_dir, tar_name)
    out_dir = os.path.join(data_dir, member_dir)
    if os.path.exists(tar_path) and not os.path.exists(out_dir):
        with tarfile.open(tar_path, "r:gz") as t:
            # "data" filter: reject absolute paths / .. traversal / device
            # nodes — dataset archives are user-supplied input
            t.extractall(data_dir, filter="data")


def load_cifar100(data_dir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """→ (images uint8 (N,32,32,3) HWC, fine labels int32 (N,))."""
    _maybe_extract(data_dir, "cifar-100-python.tar.gz", "cifar-100-python")
    path = os.path.join(data_dir, "cifar-100-python", "train" if train else "test")
    with open(path, "rb") as f:
        d = _unpickle(f)
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(d[b"fine_labels"], np.int32)
    return np.ascontiguousarray(x), y


def load_cifar10(data_dir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    _maybe_extract(data_dir, "cifar-10-python.tar.gz", "cifar-10-batches-py")
    base = os.path.join(data_dir, "cifar-10-batches-py")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for name in files:
        with open(os.path.join(base, name), "rb") as f:
            d = _unpickle(f)
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[b"labels"], np.int32))
    return np.ascontiguousarray(np.concatenate(xs)), np.concatenate(ys)


def load_mnist(data_dir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """→ (images uint8 (N,28,28,1), labels int32). Reads idx(.gz) files."""
    prefix = "train" if train else "t10k"
    base_candidates = [data_dir, os.path.join(data_dir, "MNIST", "raw")]
    for base in base_candidates:
        img_path = os.path.join(base, f"{prefix}-images-idx3-ubyte")
        lab_path = os.path.join(base, f"{prefix}-labels-idx1-ubyte")
        for p in (img_path, lab_path):
            if not os.path.exists(p) and os.path.exists(p + ".gz"):
                with gzip.open(p + ".gz", "rb") as fin, open(p, "wb") as fout:
                    fout.write(fin.read())
        if os.path.exists(img_path) and os.path.exists(lab_path):
            with open(img_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                x = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols, 1)
            with open(lab_path, "rb") as f:
                _, n = struct.unpack(">II", f.read(8))
                y = np.frombuffer(f.read(), np.uint8).astype(np.int32)
            return x, y
    raise FileNotFoundError(f"MNIST idx files not found under {base_candidates}")


def synthetic_dataset(
    n: int = 2048, size: int = 32, channels: int = 3, num_classes: int = 100, seed: int = 0,
    cache_dir: str = "./data",
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured fake data (smoke tests / no-egress runs).

    Each class gets a distinct smooth color/stripe pattern plus noise, so
    conditional models have real signal to fit.

    Reference-scale sets are disk-cached (uncompressed .npz keyed by every
    generation parameter): regenerating 50k images costs 30-240 s of
    single-core numpy per launch; the cache loads in ~1 s.
    """
    cache = None
    if n >= 8192:  # covers the reference-protocol 10k valid split too
        cache = os.path.join(
            cache_dir, f"synthetic_{n}_{size}_{channels}_{num_classes}_{seed}.npz")
        if os.path.exists(cache):
            try:
                with np.load(cache) as z:
                    return z["x"], z["y"]
            except Exception:  # noqa: BLE001 — e.g. a racer's torn write
                try:
                    os.remove(cache)
                except OSError:
                    pass
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((n, size, size, channels), np.float32)
    for c in range(channels):
        phase = (y[:, None, None] * (0.37 + 0.11 * c)) % 1.0
        imgs[..., c] = 0.5 + 0.4 * np.sin(
            2 * np.pi * (phase + xx[None] * ((y[:, None, None] % 4) + 1) * 0.25
                         + yy[None] * ((y[:, None, None] % 3) + 1) * 0.25)
        )
    imgs += rng.randn(*imgs.shape).astype(np.float32) * 0.05
    x = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    if cache is not None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{cache}.tmp.{os.getpid()}.npz"  # unique: parallel launches
            with open(tmp, "wb") as f:
                np.savez(f, x=x, y=y)  # uncompressed: load speed is the point
            os.replace(tmp, cache)
        except OSError:
            pass
    return x, y


def load_npz_dataset(path: str) -> Tuple[np.ndarray, np.ndarray, int, list]:
    """Custom dataset from one ``.npz`` (jckx extension — the reference is
    hardwired to torchvision CIFAR-100, dcgan_data_preprocessor.py:20-21):

    - ``x``: REQUIRED uint8 images, (N, H, W, C) or (N, H, W) (→ one channel).
      The decode on the device resizes to ``--image_size`` and normalizes,
      so any source resolution works.
    - ``y``: optional int labels (N,); absent → one unlabeled class.
    - ``names``: optional class-name strings (≥ the label range).

    → (x, y int32, num_classes, names). Strict about dtype: guessing a float
    range and rescaling silently would corrupt the pixel statistics every
    metric depends on.
    """
    with np.load(path, allow_pickle=False) as z:
        if "x" not in z.files:
            raise ValueError(f"{path}: needs an 'x' array of uint8 NHWC "
                             f"images; file has {sorted(z.files)}")
        x = z["x"]
        y = z["y"] if "y" in z.files else None
        names = ([str(s) for s in z["names"].tolist()]
                 if "names" in z.files else None)
    if x.dtype != np.uint8:
        raise ValueError(
            f"{path}: 'x' must be uint8 in [0, 255], got {x.dtype} — convert "
            f"explicitly (e.g. np.clip(x * 255, 0, 255).astype(np.uint8) for "
            f"[0, 1] floats); silently guessing the range would corrupt the "
            f"pixel statistics the metrics depend on")
    if x.ndim == 3:
        x = x[..., None]
    if x.ndim != 4:
        raise ValueError(f"{path}: 'x' must be (N, H, W, C) or (N, H, W), "
                         f"got shape {x.shape}")
    if y is None:
        y = np.zeros(len(x), np.int32)
        ncls = 1
    else:
        y = np.asarray(y).ravel().astype(np.int32)
        if len(y) != len(x):
            raise ValueError(f"{path}: {len(x)} images but {len(y)} labels")
        if len(y) and y.min() < 0:
            raise ValueError(f"{path}: negative label {y.min()}")
        ncls = int(y.max()) + 1 if len(y) else 1
    if names is not None:
        if len(names) < ncls:
            raise ValueError(f"{path}: {len(names)} names but labels reach "
                             f"class {ncls - 1}")
        ncls = len(names)
    else:
        names = [str(i) for i in range(ncls)]
    return np.ascontiguousarray(x), y, ncls, names


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def load_image_folder(path: str, src_size: int = 64, channels: int = 3,
                      ) -> Tuple[np.ndarray, np.ndarray, int, list]:
    """Directory of images → uint8 (N, src_size, src_size, C) + labels, as
    jckx's (``jckx/data/datasets.py:253-306``).

    Class subdirectories give labels in sorted-name order (torchvision's
    ImageFolder layout); a flat directory is one unlabelled class. Each
    image is converted to RGB (L for one channel), its SHORT side resized
    bilinearly to ``src_size``, and the square centre cropped. Needs PIL,
    imported here only.
    """
    if not os.path.isdir(path):
        raise FileNotFoundError(f"--dataset folder: {path} is not a directory")
    subdirs = sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))

    def _images_in(d):
        return [f for f in sorted(os.listdir(d)) if f.lower().endswith(_IMG_EXTS)]

    if subdirs:
        names = subdirs
        entries = [(os.path.join(path, d, f), li) for li, d in enumerate(subdirs)
                   for f in _images_in(os.path.join(path, d))]
    else:
        names = ["image"]
        entries = [(os.path.join(path, f), 0) for f in _images_in(path)]
    if not entries:
        raise ValueError(f"{path}: no images found (extensions {', '.join(_IMG_EXTS)}"
                         + (f"; class subdirs {names}" if subdirs else "") + ")")
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("--dataset folder reads images with PIL (the Pillow package), "
                          "which this Python cannot import") from e

    mode = "L" if channels == 1 else "RGB"
    x = np.empty((len(entries), src_size, src_size, channels), np.uint8)
    y = np.empty(len(entries), np.int32)
    for i, (f, li) in enumerate(entries):
        with Image.open(f) as im:
            im = im.convert(mode)
            w, h = im.size
            s = src_size / min(w, h)
            im = im.resize((max(src_size, round(w * s)), max(src_size, round(h * s))),
                           Image.BILINEAR)
            w, h = im.size
            left, top = (w - src_size) // 2, (h - src_size) // 2
            a = np.asarray(im.crop((left, top, left + src_size, top + src_size)), np.uint8)
        x[i] = a[..., None] if channels == 1 else a
        y[i] = li
    return x, y, len(names), names


def _with_cache(name: str, data_dir: str, train: bool, loader):
    """jckx's cache around an archive parser (``:309-326``): the first call
    parses and writes ``jckx_cache_<name>_<split>.bin``; later calls map it
    (read-only views, no pickle parse)."""
    from jckx_torch.data import native_io

    cache = os.path.join(data_dir, f"jckx_cache_{name}_{'train' if train else 'test'}.bin")
    got = native_io.cache_open(cache)
    if got is not None:
        return got
    x, y = loader(data_dir, train)
    try:
        os.makedirs(data_dir, exist_ok=True)
        native_io.cache_write(cache, x, y)
    except OSError:
        pass
    return x, y


def load_dataset(name: str, data_dir: str, train: bool = True, seed: int = 0,
                 num_classes: int = 0, synthetic_n: int = 0,
                 data_path: str = "", image_size: int = 64, channels: int = 3):
    """Dispatch; returns (images uint8 NHWC, labels int32, num_classes,
    names, is_synthetic).

    Falls back to synthetic data (with the real geometry) when the named
    PUBLIC archive is absent — callers log the substitution. ``num_classes``
    and ``synthetic_n`` (sample count; 0 = 4096 default, 50000 = CIFAR-scale
    for reference-protocol runs) apply to the synthetic path only.

    Custom data (``name`` "npz" or "folder") reads ``data_path`` and NEVER
    falls back: the user named a specific file or directory, so its absence
    or malformation is a loud error, not a silent swap to synthetic pixels.
    ``image_size`` / ``channels`` set the folder plane's stored resolution
    and channels (npz keeps its own; the decode on the device resizes).
    """
    if name == "npz":
        if not data_path:
            raise ValueError("--dataset npz needs --data_path pointing at "
                             "the .npz file (arrays: x uint8 NHWC, "
                             "optional y labels, optional names)")
        x, y, ncls, names = load_npz_dataset(data_path)
        if x.shape[-1] != channels:
            # loud here, not as an opaque conv input-channel error deep
            # inside the train step: npz carries the user's exact pixels,
            # so a mismatch is a config error to surface, not paper over
            raise ValueError(
                f"{data_path}: images have {x.shape[-1]} channel(s) but the "
                f"model is configured for {channels} (--channels); pass "
                f"--channels {x.shape[-1]} or convert the array")
        return x, y, ncls, names, False
    if name == "folder":
        if not data_path:
            raise ValueError("--dataset folder needs --data_path pointing at "
                             "the image directory (class subdirs = labels)")
        x, y, ncls, names = load_image_folder(data_path, src_size=image_size, channels=channels)
        return x, y, ncls, names, False
    try:
        if name == "cifar100":
            x, y = _with_cache(name, data_dir, train, load_cifar100)
            return x, y, 100, CIFAR100_CLASSES, False
        if name == "cifar10":
            x, y = _with_cache(name, data_dir, train, load_cifar10)
            names = ["airplane", "automobile", "bird", "cat", "deer",
                     "dog", "frog", "horse", "ship", "truck"]
            return x, y, 10, names, False
        if name == "mnist":
            x, y = _with_cache(name, data_dir, train, load_mnist)
            return x, y, 10, [str(i) for i in range(10)], False
    except FileNotFoundError:
        pass  # archive absent — the expected, silent fallback case
    except OSError as e:
        # not just absence: a read-only data_dir makes the gz/tar extraction
        # or cache write raise PermissionError, and a torn archive raises
        # plain OSError — still fall back (the run can proceed), but NEVER
        # silently: a transient I/O failure swapping real data for synthetic
        # would otherwise publish garbage metric absolutes with no trace
        import warnings

        warnings.warn(
            f"dataset '{name}' archive exists-but-unreadable under "
            f"{data_dir!r} ({type(e).__name__}: {e}) — falling back to "
            f"SYNTHETIC data; metric absolutes will not be comparable",
            RuntimeWarning, stacklevel=2)
    # synthetic fallback
    ch = 1 if name == "mnist" else 3
    ncls = num_classes or (10 if name in ("cifar10", "mnist") else 100)
    names = CIFAR100_CLASSES if ncls == 100 else [str(i) for i in range(ncls)]
    x, y = synthetic_dataset(synthetic_n or 4096, 32 if ch == 3 else 28, ch, ncls, seed,
                             cache_dir=data_dir)
    return x, y, ncls, names, True
