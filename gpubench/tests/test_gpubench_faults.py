"""A run with the timed path broken underneath comes out not correct:
the harness driven on the CPU (the port's plain versions) at a small
size and a ring of two bursts, past its look for a card, once sound and
once for each fault a cell of a codec can have: an answer altered where
it is produced, half of a burst left out, and every burst answered with
the first one's results (a step that returns its state unchanged).  The cells run on
one chip, so no exchange between chips can be left out."""
import pytest

from gpubench.harness import cell as cell_mod
from gpubench.harness import coders, manifest

# every cell of BENCHMARK.json, and the two encode cells whose mixes are
# kept for their return (PERF.md)
CELLS = sorted({f"{w['config']}.{w['traffic']}"
                for w in manifest.load()['workloads']}
               | {'gray8_2k_rev53.encode_stream',
                  'rgb8_2k_97ict.encode_frame'})


def _small(name):
    c = manifest.pair(*name.split('.'))
    c.config = dict(c.config, width=160, height=96, num_decomps=3)
    c.traffic = dict(c.traffic, ring=2 * c.traffic['burst'])
    return c


def _altered(outs):
    if isinstance(outs, list) and outs and isinstance(outs[0], bytes):
        s = bytearray(outs[0])
        s[len(s) // 2] ^= 0x5A
        return [bytes(s)] + outs[1:]
    plane = outs[0][0].clone()
    plane[0, 0, 0] += 3
    return [[plane] + list(outs[0][1:])] + list(outs[1:])


def _half(outs):
    if isinstance(outs, list) and outs and isinstance(outs[0], bytes):
        return outs[:len(outs) // 2]
    return [[c[:c.shape[0] // 2] for c in t] for t in outs]


FAULTS = {'sound': None, 'altered': _altered, 'half': _half,
          'stale': 'stale'}


@pytest.fixture(autouse=True)
def short_warm(monkeypatch):
    monkeypatch.setattr(cell_mod, 'WARM_SECONDS', 0.2)


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('name', CELLS)
def test_fault_makes_the_run_not_correct(name, fault, monkeypatch):
    c = _small(name)
    cls = coders.CODERS[c.traffic['direction']]
    orig = cls.collect
    how = FAULTS[fault]
    last = {}

    def collect(self, sync):
        outs = orig(self, sync)
        if how is None:
            return outs
        if how == 'stale':
            return last.setdefault('outs', outs)
        return how(outs)

    monkeypatch.setattr(cls, 'collect', collect)
    seconds = 0.6 if c.traffic['burst'] > 1 else 5.0  # two bursts or more
    out = cell_mod.run_cell(c, 2**31 + 11, seconds, False, device='cpu',
                            log=lambda m: None)
    assert out.correct == (fault == 'sound'), out.check_lines
