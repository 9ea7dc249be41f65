"""Image output: tone map + flipped PNG write.

Reference: the cv::imwrite path (raytracer/Raytracer.h:460-474) writes the
tone-mapped running average with a vertical flip (row h-1-y).  We keep the
flip so outputs are directly comparable.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """toInt (Raytracer.h:24-26) on an (H, W, 3) float radiance image."""
    v = np.power(1.0 - np.exp(-np.maximum(np.asarray(img, np.float64), 0.0)),
                 1.0 / 2.2)
    return np.clip(np.floor(v * 255.0 + 0.5), 0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """8-bit RGB PNG bytes of an (H, W, 3) uint8 array, rows top to bottom."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    # filter type 0 (None) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit truecolour
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray, tonemapped: bool = False) -> None:
    """Write (H, W, 3) image to PNG with the reference's vertical flip."""
    arr = np.asarray(img)
    if not tonemapped:
        arr = to_uint8(arr)
    with open(path, "wb") as f:
        f.write(encode_png(arr[::-1]))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two radiance images (dB)."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))
