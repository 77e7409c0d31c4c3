"""What the port's tests and ``chip_smoke.py`` share of the scale-out
checks: the launcher of gloo ranks (``python -m`` workers on a free
localhost port) and the sources of the mosaic fixtures
(``openjph_tpu_torch/testdata/mosaic_*``); also the source and keywords of
the multi-pass fixture whose codeblocks take both choices
(``MIXED_PASSES``)."""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A localhost TCP port that was free when asked."""
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(module: str, n: int, args=(), device: str = 'cpu'):
    """Start n processes of ``python -m module`` as the ranks of one
    group on a free localhost port, each on ``device``."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, '-m', module, '--coordinator', f'127.0.0.1:{port}',
         '--num-processes', str(n), '--process-id', str(k), '--device',
         device, *args], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k in range(n)]


def wait_ranks(procs, timeout: int = 120):
    """The outputs of processes from start_ranks.  Every process is waited
    for and killed at the time limit; one that exits non-zero raises
    RuntimeError with its output's end."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f'process {k} exited {p.returncode}:\n'
                               f'{out[-4000:]}')
    return outs


def flat_tile_3pass(seed: int) -> np.ndarray:
    """128x128, half its samples zero, its first 64x64 tile flat (zero
    after the DC offset: no refinement segments there)."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (128, 128)).astype(np.int32)
    img[rng.rand(128, 128) < 0.5] = 0
    img[:64, :64] = 128
    return img


# the fixtures' names, in the order chip_smoke.py checks them
MOSAIC_FIXTURES = ('mosaic_rgb_320x256_rct_t128', 'mosaic_gray_128x128_97_t64',
                   'mosaic_gray_128x128_rev_p3_t64',
                   'mosaic_gray_128x128_rev_t64')


def mosaic_fixture_sources():
    """name -> (source planes, encode keywords) of each mosaic fixture:
    RGB rim classes with RCT, 9/7, 3-pass with a flat tile and its
    single-pass twin."""
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:256, 0:320]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 2 + xx // 2) % 256,
                     (xx + yy * 3) // 4 % 256], -1)
    rgb = ((base + rng.randint(0, 4, (256, 320, 3))) % 256).astype(np.int32)
    noise = np.random.RandomState(11).randint(0, 256, (128, 128)) \
        .astype(np.int32)
    p3 = flat_tile_3pass(13)
    t64 = dict(num_decomps=2, tile_size=(64, 64))
    return dict(zip(MOSAIC_FIXTURES, (
        ([rgb[..., c] for c in range(3)],
         dict(reversible=True, num_decomps=2, tile_size=(128, 128),
              color_transform=True)),
        ([noise], dict(reversible=False, base_delta=0.01, **t64)),
        ([p3], dict(reversible=True, ht_passes=3, **t64)),
        ([p3], dict(reversible=True, **t64)))))


# openjph_tpu_torch/testdata/<MIXED_PASSES>.j2c: a 3-pass stream whose
# non-zero codeblocks are both kept multi-pass ones and cleanup-only ones
MIXED_PASSES = 'gray_256x128_rev_p3_mixed'
MIXED_PASSES_KWARGS = dict(reversible=True, num_decomps=2,
                           block_size=(32, 32), ht_passes=3)


def mixed_passes_source():
    """The 256x128 source of MIXED_PASSES: noise on the left half (its
    codeblocks keep their SigProp / MagRef passes) and a flat right half
    with sparse +-1 samples, whose codeblocks have no sample significant
    in the cleanup pass one plane coarser, so no refinement bits: those
    are coded cleanup-only."""
    rng = np.random.RandomState(2013)
    img = np.full((128, 256), 128, np.int32)
    img[:, :128] = rng.randint(0, 256, (128, 128))
    speck = rng.rand(128, 128) < 0.02
    img[:, 128:] += np.where(speck, rng.choice([-1, 1], (128, 128)), 0)
    return img
