"""256-color radio colorspace (image-over-radio payload encoding).

Rebuilds the reference color quantizer (src/packets/colors.rs:10-82): each
payload byte indexes the xterm-256 palette; RGB images quantize to the nearest
palette entry.  The palette is generated from the standard xterm-256
definition (16 system colors + 6x6x6 cube + 24-step gray ramp — the same data
the reference loads from support/colors.json) and verified against that file
by test.

The reference used a kd-tree for nearest-neighbor search; with only 256
candidate colors a brute-force distance computation is one [N, 256] matmul-
shaped reduction — faster, simpler, and batchable on an accelerator.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_SYSTEM_16 = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
    (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
    (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
    (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
]
_CUBE_LEVELS = [0, 95, 135, 175, 215, 255]


@lru_cache(maxsize=None)
def palette() -> np.ndarray:
    """uint8[256, 3] xterm-256 RGB palette (ids 0..255)."""
    out = np.zeros((256, 3), dtype=np.uint8)
    out[:16] = _SYSTEM_16
    idx = 16
    for r in _CUBE_LEVELS:
        for g in _CUBE_LEVELS:
            for b in _CUBE_LEVELS:
                out[idx] = (r, g, b)
                idx += 1
    for step in range(24):
        v = 8 + step * 10
        out[idx] = (v, v, v)
        idx += 1
    return out


def id_to_rgb(ids: np.ndarray) -> np.ndarray:
    """uint8[...] color ids -> uint8[..., 3] RGB."""
    return palette()[np.asarray(ids, dtype=np.uint8)]


def id_to_u32(ids: np.ndarray) -> np.ndarray:
    """Color ids -> packed 0xRRGGBB u32 framebuffer pixels
    (matches utils.rs:195-202's (r<<16)|(g<<8)|b)."""
    rgb = id_to_rgb(ids).astype(np.uint32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def nearest_id(rgb: np.ndarray) -> np.ndarray:
    """uint8[..., 3] RGB -> uint8[...] nearest palette id (Euclidean)."""
    flat = np.asarray(rgb, dtype=np.int32).reshape(-1, 3)
    pal = palette().astype(np.int32)
    d2 = ((flat[:, None, :] - pal[None, :, :]) ** 2).sum(axis=-1)
    ids = np.argmin(d2, axis=1).astype(np.uint8)
    return ids.reshape(np.asarray(rgb).shape[:-1])
