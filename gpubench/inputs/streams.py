"""A cell's ring of inputs from the seed: the configuration's frames,
and for the decode cells the codestreams the reference encoder makes of
them, kept by configuration and seed inside the checkout.

Every key of a configuration file is read here or named as descriptive:
``FRAME_KEYS`` shape the frames, ``ENCODE_KEYS`` pass unchanged to the
port's ``VideoEncoder`` and the reference's ``codec.encode`` alike (the
same keywords, lists as tuples), and a key in none of the three sets is
refused, so a configuration never states what the run does not do."""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from ..reference.htj2k import codec
from .frames import make_frames

FRAME_KEYS = ('width', 'height', 'components', 'content')
ENCODE_KEYS = ('bit_depth', 'is_signed', 'reversible', 'num_decomps',
               'block_size', 'prog_order', 'color_transform', 'base_delta',
               'qfactor', 'ht_passes', 'vert_causal', 'tile_size',
               'tile_offset', 'image_offset', 'precincts', 'tlm_marker',
               'tileparts', 'profile')
DESCRIPTIVE_KEYS = ('name', 'source', 'deployment', 'wavelet', 'assumed',
                    'reduced', 'limits')
_PAIRS = ('block_size', 'tile_size', 'tile_offset', 'image_offset')

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(os.path.dirname(BENCH_DIR), 'build', 'gpubench',
                         'inputs')


def check_config(config: dict) -> None:
    """ValueError on a key the harness does not use, or a wavelet that
    contradicts ``reversible``."""
    unknown = set(config) - set(FRAME_KEYS + ENCODE_KEYS + DESCRIPTIVE_KEYS)
    if unknown:
        raise ValueError(f'configuration {config.get("name")!r}: keys '
                         f'{sorted(unknown)} are not used by the harness')
    wavelet = config.get('wavelet')
    if wavelet is not None and \
            (wavelet == '5/3') != bool(config.get('reversible', True)):
        raise ValueError(f'wavelet {wavelet} with reversible='
                         f'{config.get("reversible")}')


def encode_kwargs(config: dict) -> dict:
    """The configuration's encode keywords, for the port and the
    reference alike."""
    check_config(config)
    kw = {k: config[k] for k in ENCODE_KEYS if k in config}
    for k in _PAIRS:
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    if kw.get('precincts') is not None:
        kw['precincts'] = [tuple(p) for p in kw['precincts']]
    return kw


def frame_dtype(config: dict):
    """The narrowest integer type of the configuration's samples: what a
    capture or a file hands the encoder."""
    bits = config['bit_depth']
    width = 8 if bits <= 8 else 16 if bits <= 16 else 32
    signed = config.get('is_signed', False)
    return np.dtype(f'{"i" if signed else "u"}{width // 8}')


def ring_frames(config: dict, seed: int, n: int) -> List[np.ndarray]:
    check_config(config)
    frames = make_frames(seed, n, config['height'], config['width'],
                         config['components'], config['bit_depth'],
                         config['content']['grain_sigma'])
    shift = (1 << (config['bit_depth'] - 1)) \
        if config.get('is_signed', False) else 0
    return [(f - shift).astype(frame_dtype(config)) for f in frames]


def ring_streams(config: dict, frames, workers: int = 4) -> List[bytes]:
    """The reference encoder's codestream of each frame."""
    kw = encode_kwargs(config)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda f: codec.encode(f, **kw), frames))


def _sources_digest() -> str:
    """What the kept codestreams depend on besides the configuration and
    the seed: the frame maker, this file and the reference encoder."""
    h = hashlib.sha256()
    for top in ('inputs', 'reference'):
        for dirpath, dirs, files in sorted(os.walk(os.path.join(BENCH_DIR,
                                                                top))):
            dirs.sort()
            for name in sorted(files):
                if name.endswith(('.py', '.cpp', '.npz')):
                    path = os.path.join(dirpath, name)
                    h.update(os.path.relpath(path, BENCH_DIR).encode())
                    with open(path, 'rb') as f:
                        h.update(f.read())
    return h.hexdigest()[:16]


def kept_ring_streams(config: dict, seed: int, n: int) -> List[bytes]:
    """``ring_streams`` of the seed's ``n`` frames, read from
    ``build/gpubench/inputs/`` where an earlier run of this
    configuration, seed and sources kept them, else made and kept."""
    key = hashlib.sha256(json.dumps(config, sort_keys=True).encode()
                         + f'|{seed}|{n}|{_sources_digest()}'.encode())
    path = os.path.join(CACHE_DIR,
                        f'{config["name"]}-{key.hexdigest()[:24]}.npz')
    try:
        with np.load(path) as z:
            blob, ends = z['blob'], z['ends']
        starts = np.concatenate([[0], ends[:-1]])
        return [blob[a:b].tobytes() for a, b in zip(starts, ends)]
    except (OSError, KeyError, ValueError):
        pass
    streams = ring_streams(config, ring_frames(config, seed, n))
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp.npz'
    np.savez(tmp, blob=np.frombuffer(b''.join(streams), np.uint8),
             ends=np.cumsum([len(s) for s in streams]))
    os.replace(tmp, path)
    return streams


def ring_inputs(config: dict, seed: int, n: int, direction: str) -> list:
    """A cell's ring: host frames to encode, or codestreams to decode."""
    if direction == 'decode':
        return kept_ring_streams(config, seed, n)
    return ring_frames(config, seed, n)
