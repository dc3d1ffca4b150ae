"""Input pipeline — port of ``decode_batch`` (``jckx/data/pipeline.py:34-48``),
``DCGANDataPreprocessor`` (``:176-236``) and ``CGANDataPreprocessor``
(``:238-247``).

As in jckx, the uint8 set is loaded once and lives on the device (the
trainer uploads it); each step gathers its batch by index and decodes it
there: uint8 → [0, 1] → bilinear resize to the model's size → [-1, 1],
the reference's Resize(64) + ToTensor + Normalize(0.5, 0.5)
(dcgan_data_preprocessor.py:38-43).

``jax.image.resize(method="bilinear")`` samples at half-pixel centres and
renormalizes its triangle weights at the border. When it upsamples, that
is ``F.interpolate(mode="bilinear", align_corners=False)``; when it
downsamples, it widens the triangle by the scale, which is
``antialias=True`` (tests/test_torch_data.py holds both against jckx).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from jckx_torch.data.datasets import load_dataset
from jckx_torch.logging.main_logger import MainLogger


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC float → (N, size, size, C), as ``jax.image.resize`` bilinear."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    nchw = x.permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=size < max(x.shape[1], x.shape[2]))
    return y.permute(0, 2, 3, 1)


def decode_batch(u8: torch.Tensor, image_size: int,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC → resized images in [-1, 1], NHWC, in ``compute_dtype``
    (the resize in f32, as jckx)."""
    x = resize_bilinear(u8.float() / 255.0, image_size)
    return ((x - 0.5) / 0.5).to(compute_dtype)


class DCGANDataPreprocessor:
    """Unconditional data (reference dcgan_data_preprocessor.py:11-75):
    ``images_u8`` (N, H, W, C) and ``labels_np`` on the host, the class
    names, the per-channel ``data_mean`` / ``data_std`` the reference
    logs, and ``metric_source``, the (images, labels) pair the metrics
    engine extracts real features from."""

    def __init__(self, cfg):
        logger = MainLogger(cfg)
        x, y, ncls, names, synthetic = load_dataset(
            cfg.dataset, cfg.data_dir, train=True, seed=cfg.seed,
            num_classes=cfg.num_classes, synthetic_n=cfg.synthetic_size,
            data_path=cfg.data_path, channels=cfg.channels)
        if synthetic and cfg.dataset != "synthetic":
            logger.warning(
                f"dataset '{cfg.dataset}' not found under {cfg.data_dir}; "
                f"using deterministic synthetic data ({x.shape[0]} samples)")
        self.images_u8, self.labels_np = x, y
        self.num_classes, self.class_names = ncls, names
        # f64 reductions straight off the uint8 slab (no float copy of the set)
        self.data_mean = (x.mean(axis=(0, 1, 2), dtype=np.float64) / 255.0).tolist()
        ex2 = np.square(x, dtype=np.uint16).mean(axis=(0, 1, 2), dtype=np.float64) / 255.0**2
        self.data_std = np.sqrt(np.maximum(ex2 - np.square(self.data_mean), 0.0)).tolist()
        logger.debug(f"data mean: {self.data_mean}\tdata std: {self.data_std}")

    @property
    def metric_source(self):
        return self.images_u8, self.labels_np


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Class ids (N,) → f32 one-hot (N, K) on the labels' device."""
    return F.one_hot(labels.long(), num_classes).float()


class CGANDataPreprocessor(DCGANDataPreprocessor):
    """Conditional data (reference cgan_data_preprocessor.py:11-94): adds
    the index → class-name map and ``one_hot``. The trainer keeps the labels
    on the device as int64 and gathers them by the images' index."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.idx_to_labels = dict(enumerate(self.class_names))

    def one_hot(self, labels: torch.Tensor) -> torch.Tensor:
        return one_hot(labels, self.num_classes)
