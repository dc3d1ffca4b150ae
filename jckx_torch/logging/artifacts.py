"""Sample grids as PNG files — port of ``jckx/logging/artifacts.py:27-60``.

``make_grid`` is numpy, as in jckx. The PNG writer is ``zlib`` + ``struct``
so that serving needs no imaging library (jckx's ``save_image_grid`` uses
PIL).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,1] float NHWC → uint8, min-max normalized per batch
    (torchvision make_grid(normalize=True) semantics)."""
    x = np.asarray(images, np.float32)
    lo, hi = x.min(), x.max()
    x = (x - lo) / max(hi - lo, 1e-8)
    return (x * 255).astype(np.uint8)


def make_grid(images: np.ndarray, ncol: int = 8, padding: int = 2) -> np.ndarray:
    """NHWC uint8/float → single HWC uint8 grid image."""
    imgs = _to_uint8(images)
    n, h, w, c = imgs.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.zeros(
        (nrow * (h + padding) + padding, ncol * (w + padding) + padding, c), np.uint8
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0 : y0 + h, x0 : x0 + w] = imgs[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """HWC (C = 1, 3 or 4) or HW uint8 → PNG bytes (8-bit, no filtering)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}.get(c)
    if color is None:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image_grid(path: str, images, ncol: int = 8, padding: int = 2) -> None:
    grid = make_grid(np.asarray(images), ncol=ncol, padding=padding)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
