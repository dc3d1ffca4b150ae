"""Sample grids, the CGAN class panel and the loss curve as PNG files —
port of ``jckx/logging/artifacts.py``.

``make_grid`` is numpy, as in jckx. The PNG writer is ``zlib`` + ``struct``,
and the loss curve and the class panel are drawn into numpy rasters, the
panel's titles in a built-in 5×7 bitmap font, so that none of them needs an
imaging or plotting library (jckx uses PIL and matplotlib, which the
card's machine lacks).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

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


# 5×7 glyphs, one hex byte per row, top row first, bit 4 the leftmost
# column; letters are drawn as capitals. Enough for the class names of
# CIFAR-100, CIFAR-10 and MNIST; any other character draws as a blank.
_GLYPHS = dict(zip("abcdefghijklmnopqrstuvwxyz0123456789_-", (
    "0e1111111f1111", "1e11111e11111e", "0e11101010110e", "1c12111111121c",  # a b c d
    "1f10101e10101f", "1f10101e101010", "0e11101711110f", "1111111f111111",  # e f g h
    "0e04040404040e", "0702020202120c", "11121418141211", "1010101010101f",  # i j k l
    "111b1515111111", "11111915131111", "0e11111111110e", "1e11111e101010",  # m n o p
    "0e11111115120d", "1e11111e141211", "0f10100e01011e", "1f040404040404",  # q r s t
    "1111111111110e", "11111111110a04", "1111111515150a", "11110a040a1111",  # u v w x
    "1111110a040404", "1f01020408101f",                                      # y z
    "0e11131519110e", "040c040404040e", "0e11010204081f", "1f02040201110e",  # 0 1 2 3
    "02060a121f0202", "1f101e0101110e", "0608101e11110e", "1f010204080808",  # 4 5 6 7
    "0e11110e11110e", "0e11110f01020c",                                      # 8 9
    "0000000000001f", "0000001f000000",                                      # _ -
)))
_GLYPH_W, _GLYPH_H, _ADVANCE = 5, 7, 6


def _glyph(ch: str) -> np.ndarray:
    """(7, 5) bool bitmap of ``ch``; blank for a character the font lacks."""
    rows = _GLYPHS.get(ch.lower(), "00" * _GLYPH_H)
    bits = [int(rows[2 * r:2 * r + 2], 16) for r in range(_GLYPH_H)]
    return np.array([[(b >> (_GLYPH_W - 1 - c)) & 1 for c in range(_GLYPH_W)] for b in bits], bool)


def text_raster(text: str) -> np.ndarray:
    """``text`` in the bitmap font → (7, 6·len − 1) bool raster."""
    out = np.zeros((_GLYPH_H, max(_ADVANCE * len(text) - 1, 0)), bool)
    for i, ch in enumerate(text):
        out[:, _ADVANCE * i:_ADVANCE * i + _GLYPH_W] = _glyph(ch)
    return out


def labeled_grid_image(images, labels: Sequence[str], ncol: int = 10) -> np.ndarray:
    """The CGAN per-class panel (cgan_trainer.py:93-103) as an (H, W, 3)
    uint8 raster on white: up to ``ncol``×``ncol`` cells, each its label
    in black above its image, images min-max normalized over the panel."""
    imgs = _to_uint8(np.asarray(images))
    n, h, w, c = imgs.shape
    n = min(n, ncol * ncol)
    if c == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
    pad, title = 4, _GLYPH_H + 3
    cell_w = max(w, max((text_raster(str(labels[i])).shape[1] for i in range(n)), default=0))
    nrow = -(-n // ncol)
    cols = min(ncol, n)
    panel = np.full((nrow * (title + h + pad) + pad, cols * (cell_w + pad) + pad, 3), 255, np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0, x0 = pad + r * (title + h + pad), pad + col * (cell_w + pad)
        t = text_raster(str(labels[i]))
        tx = x0 + (cell_w - t.shape[1]) // 2
        panel[y0:y0 + _GLYPH_H, tx:tx + t.shape[1]][t] = 0
        ix = x0 + (cell_w - w) // 2
        panel[y0 + title:y0 + title + h, ix:ix + w] = imgs[i][..., :3]
    return panel


def save_labeled_grid(path: str, images, labels: Sequence[str], ncol: int = 10) -> None:
    """``img/<iters>_fake_image.png`` of the CGAN trainer."""
    _write_png(path, labeled_grid_image(images, labels, ncol))


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
