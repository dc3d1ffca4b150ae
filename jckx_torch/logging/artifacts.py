"""Sample grids and the loss curve as PNG files — port of
``jckx/logging/artifacts.py:27-60,80-91``.

``make_grid`` is numpy, as in jckx. The PNG writer is ``zlib`` + ``struct``
and the loss curve is drawn into a numpy raster, so that neither needs an
imaging or plotting library (jckx uses PIL and matplotlib, which the
card's machine lacks). The CGAN class panel is not ported yet (ROADMAP A8).
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


def _write_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_image_grid(path: str, images, ncol: int = 8, padding: int = 2) -> None:
    _write_png(path, make_grid(np.asarray(images), ncol=ncol, padding=padding))


# the loss plot: canvas, plot box inside it, and the two curves' colours
_W, _H, _MARGIN = 800, 600, 40
_D_COLOR, _G_COLOR = (31, 119, 180), (255, 127, 14)


def _polyline(img: np.ndarray, px: np.ndarray, py: np.ndarray, color) -> None:
    """Draw the polyline through pixel coordinates (px, py), 2 px thick."""
    if px.size == 1:
        px, py = np.repeat(px, 2), np.repeat(py, 2)
    x0, y0, dx, dy = px[:-1], py[:-1], np.diff(px), np.diff(py)
    n = np.ceil(np.maximum(np.abs(dx), np.abs(dy))).astype(np.int64) + 1
    seg = np.repeat(np.arange(n.size), n)
    t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.maximum(n[seg] - 1, 1)
    xs = np.rint(x0[seg] + t * dx[seg]).astype(np.int64)
    ys = np.rint(y0[seg] + t * dy[seg]).astype(np.int64)
    for oy in (0, 1):
        img[np.clip(ys + oy, 0, img.shape[0] - 1), xs] = color


def loss_curve_image(losses_d, losses_g) -> np.ndarray:
    """D's loss (blue) and G's loss (orange) against the iteration, on one
    y-scale, as an (H, W, 3) uint8 raster. Non-finite points are left out."""
    img = np.full((_H, _W, 3), 255, np.uint8)
    x0, x1, y0, y1 = _MARGIN, _W - _MARGIN, _MARGIN, _H - _MARGIN
    img[y1, x0:x1 + 1] = 0  # axes
    img[y0:y1 + 1, x0] = 0
    series = [np.asarray(s, np.float64) for s in (losses_d, losses_g)]
    finite = np.concatenate([s[np.isfinite(s)] for s in series])
    if finite.size == 0:
        return img
    lo, hi = finite.min(), finite.max()
    span = hi - lo if hi > lo else 1.0
    for s, color in zip(series, (_D_COLOR, _G_COLOR)):
        it = np.arange(s.size, dtype=np.float64)
        keep = np.isfinite(s)
        if not keep.any():
            continue
        px = x0 + (x1 - x0) * it[keep] / max(s.size - 1, 1)
        py = y1 - (y1 - y0) * (s[keep] - lo) / span
        _polyline(img, px, py, color)
    return img


def save_loss_curve(path: str, losses_d, losses_g) -> None:
    """``loss.png`` (reference dcgan_trainer.py:228-239), drawn without
    matplotlib, which the card's machine lacks."""
    _write_png(path, loss_curve_image(losses_d, losses_g))
