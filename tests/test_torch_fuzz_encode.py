"""The port's encode fuzzer (openjph_tpu_torch.fuzzing.fuzz_encode) on
the CPU, against the JAX package's harness (fuzzing/fuzz_encode.py) and
encoder:

- ``random_params`` draws the JAX harness's parameter sets and planes
  from the same RandomState;
- ten of those sets encode on the port's CPU path byte-identical to
  ``openjph_tpu.encode``, or both reject the set with a ValueError
  (OjphError included); a reversible stream decodes back equal to its
  planes;
- ``run`` holds the port's device encode to its CPU encode
  (``check_params``) and counts as the JAX harness does;
- the decode fuzzer's seed pool (``fuzz_decode.make_seeds``) is the JAX
  harness's, byte for byte.
"""
import importlib.util
import os

import numpy as np
import pytest

import openjph_tpu
from openjph_tpu.core import message as jmsg

from openjph_tpu_torch import decode
from openjph_tpu_torch.core import message as msg
from openjph_tpu_torch.fuzzing import fuzz_decode
from openjph_tpu_torch.fuzzing import fuzz_encode as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = 10
SEED = 11


def _jax_harness(name):
    spec = importlib.util.spec_from_file_location(
        'jax_' + name, os.path.join(REPO, 'fuzzing', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _quiet():
    # odd parameter sets draw warnings (dropped tile-part divisions)
    old, jold = msg._level, jmsg._level
    msg.set_message_level(msg.NO_MSG)
    jmsg.set_message_level(jmsg.NO_MSG)
    yield
    msg._level, jmsg._level = old, jold


@pytest.fixture(scope='module')
def param_sets():
    rng = np.random.RandomState(SEED)
    return [F.random_params(rng) for _ in range(SETS)]


def test_random_params_draws_the_jax_harness_sets():
    jax_random_params = _jax_harness('fuzz_encode').random_params
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(50):
        (pa, ka), (pb, kb) = F.random_params(a), jax_random_params(b)
        assert ka == kb
        assert len(pa) == len(pb)
        assert all(np.array_equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize('it', range(SETS))
def test_params_set_encodes_as_the_jax_package(param_sets, it):
    planes, kw = param_sets[it]
    got, err = F.encode_or_error(planes, kw, 'cpu')
    try:
        want, werr = openjph_tpu.encode(planes, **kw), None
    except ValueError as e:
        want, werr = None, e
    assert (err is None) == (werr is None), (kw, err, werr)
    assert got == want, kw
    if got is not None and kw['reversible']:
        outs = decode(got, device='cpu')
        assert all(np.array_equal(o, p) for o, p in zip(outs, planes))


def test_run_counts_as_the_jax_harness():
    n_ok, n_rej, n_oracle = F.run(2, SEED, device='cpu', quiet=True)
    assert n_ok + n_rej == 2


def test_decode_seed_pool_is_the_jax_harness_pool():
    jax_seeds = _jax_harness('fuzz_decode').make_seeds()
    seeds = fuzz_decode.make_seeds('cpu')
    assert len(seeds) == len(jax_seeds) == 58
    assert seeds == jax_seeds
