"""Validation panels: input image, ground-truth instances, prediction side
by side (a copy of ``pctrans_tpu/utils/visualizer.py``).

Instance ids take colours from a fixed pseudo-random palette, so an id
keeps its colour across iterations.  A panel goes to TensorBoard when the
monitor has a writer; otherwise it is written as a PNG under
``<output_dir>/vis``, with PIL where it imports and with the small stdlib
encoder :func:`write_png` (``zlib`` + ``struct``) where it does not.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def _palette(n: int = 256, seed: int = 7) -> np.ndarray:
    rs = np.random.RandomState(seed)
    pal = rs.randint(40, 255, (n, 3)).astype(np.uint8)
    pal[0] = 0                               # background stays black
    return pal


_PALETTE = _palette()


def colorize_labels(labels: np.ndarray) -> np.ndarray:
    """[H, W] int instance map -> [H, W, 3] uint8 colour image."""
    return _PALETTE[labels.astype(np.int64) % len(_PALETTE)]


def normalize_image(image: np.ndarray) -> np.ndarray:
    """[H, W, C] float image -> [H, W, 3] uint8 for display."""
    img = np.asarray(image, np.float32)
    lo, hi = float(img.min()), float(img.max())
    img = ((img - lo) / (hi - lo + 1e-6) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    return img[..., :3]


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG (filter 0 on every row, one
    zlib stream), with no image library."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


class Visualizer:
    """Panel writer: TensorBoard ``add_image`` when a writer is given, PNG
    files under ``<output_dir>/vis`` otherwise."""

    def __init__(self, output_dir: str, tb_writer=None, max_panels: int = 4):
        self.output_dir = os.path.join(output_dir, "vis")
        self.tb = tb_writer
        self.max_panels = max_panels

    def panel(self, image: np.ndarray, label: Optional[np.ndarray],
              pred: Optional[np.ndarray]) -> np.ndarray:
        parts = [normalize_image(image)]
        if label is not None:
            parts.append(colorize_labels(label))
        if pred is not None:
            parts.append(colorize_labels(pred))
        h = max(p.shape[0] for p in parts)
        parts = [np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0))) for p in parts]
        return np.concatenate(parts, axis=1)

    def visualize(self, iteration: int, images: np.ndarray,
                  labels: Optional[np.ndarray] = None,
                  preds: Optional[np.ndarray] = None, tag: str = "val") -> list:
        """images [B, H, W, C]; labels/preds [B, H, W] instance maps.
        Returns the PNG paths written."""
        written = []
        for b in range(min(self.max_panels, images.shape[0])):
            panel = self.panel(images[b], None if labels is None else labels[b],
                               None if preds is None else preds[b])
            if self.tb is not None:
                self.tb.add_image(f"{tag}/sample{b}", panel, iteration, dataformats="HWC")
                continue
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir, f"{tag}_{iteration:06d}_{b}.png")
            try:
                from PIL import Image
            except ImportError:
                write_png(path, panel)
            else:
                Image.fromarray(panel).save(path)
            written.append(path)
        return written
