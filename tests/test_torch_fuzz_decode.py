"""The port's decode fuzzer (openjph_tpu_torch.fuzzing.fuzz_decode) on
the CPU, against the JAX package's harness (fuzzing/fuzz_decode.py) and
decoder:

- ``mutate`` draws the JAX harness's bytes from the same RandomState;
- ten streams of the OpenJPH corpus (fuzzing/seed_corpus/) decode on the
  port's CPU path (raw runner) equal to ``openjph_tpu.decode``:
  reversible components bit-exact, irreversible ones within 1 after
  clipping to the sample range (``_paths_agree``);
- twelve streams mutated from the port's seed pool (RandomState(2024))
  get the same accept or reject from the port's CPU decode and
  ``openjph_tpu.decode``, strict and resilient, with outputs equal as
  above where strict mode accepts;
- ``run`` holds the raw runner to the dense one (``check_stream``) and
  counts its outcomes as the JAX harness does.
"""
import importlib.util
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

import openjph_tpu
from openjph_tpu.core import message as jmsg

from openjph_tpu_torch.core import markers as mk
from openjph_tpu_torch.core import message as msg
from openjph_tpu_torch.fuzzing import fuzz_decode as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_CASES = ('blk4', 'wide_b1024x4', 'yuv420', 'nlt3_signed', 'g16_rev',
                'po_rpcl', 'tp_r_tlm', 'tile33_lossy', 'ht3pass',
                'rgb_lossy')
MUTATIONS = 12
MUTATION_SEED = 2024


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        'jax_fuzz_decode', os.path.join(REPO, 'fuzzing', 'fuzz_decode.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _quiet():
    # damaged codestreams are expected to be noisy
    old, jold = msg._level, jmsg._level
    msg.set_message_level(msg.NO_MSG)
    jmsg.set_message_level(jmsg.NO_MSG)
    yield
    msg._level, jmsg._level = old, jold


@pytest.fixture(scope='module')
def seeds():
    return F.make_seeds('cpu')


@pytest.fixture(scope='module')
def mutations(seeds):
    rng = np.random.RandomState(MUTATION_SEED)
    return [F.mutate(rng, seeds[rng.randint(0, len(seeds))])
            for _ in range(MUTATIONS)]


def _jax_decode(data, resilient):
    try:
        return openjph_tpu.decode(data, resilient=resilient), None
    except (ValueError, EOFError) as e:
        return None, e


def _kind(err):
    """The contract's classes of outcome: accepted, ValueError (OjphError
    included) or EOFError."""
    if err is None:
        return 'accepted'
    return 'EOFError' if isinstance(err, EOFError) else 'ValueError'


def test_mutate_draws_the_jax_harness_bytes():
    jax_mutate = _jax_harness().mutate
    corpus = F.load_corpus()
    assert len(corpus) == 52
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(200):
        k = a.randint(0, len(corpus))
        assert b.randint(0, len(corpus)) == k
        assert F.mutate(a, corpus[k]) == jax_mutate(b, corpus[k])


@pytest.mark.parametrize('name', CORPUS_CASES)
def test_corpus_stream_decodes_as_the_jax_package(name):
    with open(os.path.join(F.CORPUS, name + '.j2c'), 'rb') as fh:
        data = fh.read()
    ref = openjph_tpu.decode(data)
    hdr = mk.read_main_header(data)
    got, err = F.decode_or_error(data, 'cpu', True, False)
    assert err is None, err
    F._paths_agree(hdr, ref, got, name)


@pytest.mark.parametrize('it', range(MUTATIONS))
def test_mutated_stream_meets_the_jax_contract(mutations, it):
    data = mutations[it]
    refs = F.cpu_reference(data)
    for (got, err), resilient in zip(refs, (False, True)):
        want, werr = _jax_decode(data, resilient)
        assert _kind(err) == _kind(werr), (resilient, err, werr)
        if refs[0][0] is not None and got is not None:
            F._paths_agree(mk.read_main_header(data), want, got,
                           f'mutation {it}, resilient={resilient}')


def test_run_counts_as_the_jax_harness(seeds, monkeypatch):
    monkeypatch.setattr(F, 'make_seeds', lambda device: seeds)
    stats = F.run(3, MUTATION_SEED, device='cpu', seed_subset=8, quiet=True)
    assert stats['ok'] + stats['valueerror'] + stats['eof'] == 3
    assert stats['device_ok'] == stats['ok']
    assert stats['device_resilient_ok'] == stats['resilient_ok']
    assert sum(stats['launches'].values()) == 0  # CPU: no kernel


def test_a_rejection_is_kept_without_its_frames():
    """A kept error holds no frame of the failed decode (on the card
    those frames hold its device tensors, so the decoder fuzzer's peak
    memory read the previous stream's tensors on top of the next's)."""
    data = F.load_corpus()[0]
    _, err = F.decode_or_error(data[:len(data) // 2], 'cpu', True, False)
    assert isinstance(err, (ValueError, EOFError))
    e = err
    while e is not None:
        assert e.__traceback__ is None
        e = e.__context__


@pytest.mark.filterwarnings('ignore::RuntimeWarning')  # runpy: imported
def test_the_command_line_runs_fresh_process_batches(monkeypatch, capsys):
    """``python -m ...fuzz_decode 151 7`` runs batches of 150 and 1
    iterations from seeds 7 and 157, each a fresh process of the module
    under its own name, and sums their stats (the processes are faked)."""
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        stats = {'ok': 1, 'valueerror': 0, 'eof': 0, 'resilient_ok': 1,
                 'device_ok': 1, 'device_resilient_ok': 1,
                 'launches': {'ht_cleanup_decode_raw': 2},
                 'peak_bytes': len(calls)}
        return subprocess.CompletedProcess(cmd, 0, 'done: '
                                           + json.dumps(stats), '')

    monkeypatch.setattr(subprocess, 'run', fake_run)
    monkeypatch.setattr(sys, 'argv', ['fuzz_decode', '151', '7', '--device',
                                      'cpu'])
    with pytest.raises(SystemExit) as e:
        runpy.run_module('openjph_tpu_torch.fuzzing.fuzz_decode',
                         run_name='__main__', alter_sys=True)
    assert e.value.code == 0
    assert [c[2:5] for c in calls] == [
        ['openjph_tpu_torch.fuzzing.fuzz_decode', '150', '7'],
        ['openjph_tpu_torch.fuzzing.fuzz_decode', '1', '157']]
    assert all('--child' in c and c[c.index('--device') + 1] == 'cpu'
               for c in calls)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last[len('done: '):]) == {
        'ok': 2, 'valueerror': 0, 'eof': 0, 'resilient_ok': 2,
        'device_ok': 2, 'device_resilient_ok': 2,
        'launches': {'ht_cleanup_decode_raw': 4}, 'peak_bytes': 2}
