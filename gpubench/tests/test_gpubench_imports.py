"""Nothing under gpubench/ imports jax, jaxlib, flax or openjph_tpu, and
gpubench/reference/ imports nothing of openjph_tpu_torch either: by the
sources (ast) and in a fresh interpreter, top-level names compared
whole."""
import ast
import os
import subprocess
import sys

from gpubench.harness import guard, manifest

BENCH = manifest.BENCH_DIR


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        assert guard.banned_in(_imports(path)) == [], path


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, 'reference')):
        for name in _imports(path):
            assert name.split('.')[0] != 'openjph_tpu_torch', path


def test_fresh_interpreter():
    """The reference and the harness loaded and used: no banned module;
    after the reference alone, no module of the port."""
    code = '''
import sys, numpy as np
sys.path.insert(0, sys.argv[1])
from gpubench.reference import compare, control
from gpubench.reference.htj2k import codec
img = np.random.default_rng(0).integers(0, 256, (40, 72, 3))
s = codec.encode(img, reversible=False, num_decomps=2, base_delta=0.01)
compare.band_planes(s); control.decode(s); codec.decode(s)
tops = {m.split('.')[0] for m in sys.modules}
assert 'openjph_tpu_torch' not in tops, 'reference loaded the port'
from gpubench.harness import cell, coders
from gpubench.harness.guard import loaded_banned
import openjph_tpu_torch
print(loaded_banned())
'''
    out = subprocess.run([sys.executable, '-c', code, manifest.ROOT],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
