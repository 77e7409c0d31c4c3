"""Build helper: compiles the package's C++ and CUDA sources into
shared libraries at first use and loads them with ctypes.

Libraries land in ``<checkout>/build/openjph_tpu_torch/`` under a name
that carries a hash of the sources and the command line, so an edited
source rebuilds and a stale library is never loaded.  A file lock
serialises concurrent builders (pytest workers, several processes on
one host); the compiler writes to a temporary name that is renamed
into place, so a reader never sees a half-written library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'openjph_tpu_torch')

# seconds spent compiling per library name in this process (0 when the
# library was already built); chip_smoke.py reports them
BUILD_SECONDS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler, or RuntimeError when there is none."""
    cand = shutil.which('nvcc')
    if cand is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        cand = '/usr/local/cuda/bin/nvcc'
    if cand is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'openjph_tpu_torch build only where the CUDA '
                           'toolkit is installed')
    return cand


def build_library(name: str, sources, cmd) -> str:
    """Compile ``sources`` into ``BUILD_DIR/<name>-<hash>.so`` unless
    that file exists; return its path.  ``cmd(out_path)`` gives the
    compiler argv writing to ``out_path``."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, 'rb') as fh:
            h.update(fh.read())
    h.update(' '.join(cmd('OUT')).encode())
    so = os.path.join(BUILD_DIR, f'{name}-{h.hexdigest()[:16]}.so')
    if os.path.exists(so):
        BUILD_SECONDS.setdefault(name, 0.0)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f'{name}.lock'), 'w') as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so):
                tmp = f'{so}.{os.getpid()}.tmp'
                t0 = time.perf_counter()
                r = subprocess.run(cmd(tmp), capture_output=True,
                                   text=True)
                if r.returncode != 0:
                    raise RuntimeError(
                        f'building {name} failed:\n{r.stdout}\n{r.stderr}')
                os.replace(tmp, so)
                BUILD_SECONDS[name] = time.perf_counter() - t0
            else:
                BUILD_SECONDS.setdefault(name, 0.0)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


def load_library(name: str, sources, cmd) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(name, sources, cmd))
