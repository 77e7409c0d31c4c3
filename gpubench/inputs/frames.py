"""Seeded test frames: drifting 2-D sines plus film grain.

The pattern is a frozen copy of openjph_tpu_torch/tools/ab_upload.py::
make_frames (itself tools/ab_upload.py's and bench.py's make_frames),
with the RGB variant of bench.py:123, and with its fixed RandomState(42)
and fixed phases replaced by draws from the run's seed: every seed gives
frames of the same size, pattern and grain strength, so the coded sizes
and the work per frame stay alike from seed to seed.  Each sine is
separable, so a frame costs outer products and one draw of grain.
"""
from __future__ import annotations

from typing import List

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one use of the run's seed (any whole number)."""
    tag = int.from_bytes(stream.encode(), 'little')
    return np.random.default_rng([seed % (1 << 64), tag])


def make_frames(seed: int, n: int, height: int, width: int,
                components: int, bit_depth: int = 8,
                grain_sigma: float = 6.0) -> List[np.ndarray]:
    """``n`` distinct frames, each an int32 (H, W) array for one
    component, or (H, W, C) for C of them: R, G, B, then further planes
    (alpha, say), each offset from the shared pattern by a sine of its
    own (int64 beyond 30 bits)."""
    if components < 1:
        raise ValueError(f'{components} components')
    rng = rng_for(seed, 'frames')
    t0 = rng.uniform(0.0, 64.0)
    scale = ((1 << bit_depth) - 1) / 255.0
    top = (1 << bit_depth) - 1
    itype = np.int64 if bit_depth > 30 else np.int32
    y = np.arange(height, dtype=np.float32)[:, None]
    x = np.arange(width, dtype=np.float32)[None, :]
    frames = []
    for k in range(n):
        t = np.float32(t0 + k)
        # 60 sin(x/97 + .8t) cos(y/83 - .35t) + 40 sin((x+y)/211 + t)
        img = (60 * np.cos(y / 83.0 - t * 0.35)) * np.sin(x / 97.0 + t * 0.8)
        img += 40 * (np.sin(x / 211.0) * np.cos(y / 211.0 + t)
                     + np.cos(x / 211.0) * np.sin(y / 211.0 + t))
        img += 127
        img += rng.standard_normal((height, width), dtype=np.float32) \
            * np.float32(grain_sigma)
        img *= scale
        g = np.clip(img, 0, top).astype(itype)
        if components == 1:
            frames.append(g)
            continue
        r = np.clip(img + scale * 25 * np.sin(y / 50.0 + t), 0,
                    top).astype(itype)
        b = np.clip(img - scale * 20 * np.cos(x / 61.0 - t), 0,
                    top).astype(itype)
        planes = [r, g, b][:components]
        for j in range(3, components):
            wave = np.sin((x + j * y) / (60.0 + 7 * j) + t)
            planes.append(np.clip(img + scale * (10 + 5 * j) * wave, 0,
                                  top).astype(itype))
        frames.append(np.stack(planes, axis=-1))
    return frames
